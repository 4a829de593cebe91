"""Batched LDPC(174,91) sum-product belief propagation.

Batched replacement for ft8_lib's serial bp_decode (20 iterations per
candidate at /root/reference/rtlsdr_ft8d.c:1476): ALL candidates of all
channels run in lockstep as one vectorized message-passing schedule with
fixed iteration count and masked best-so-far tracking (the C early-exit
becomes a frozen minimum — identical results, compiler-friendly control
flow). Check-node updates use exact exclusive products over the <=7-entry
rows rather than division, so zero messages (masked boundary LLRs) are
numerically safe.
"""

import functools
import os as _os

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol.constants import FT8_LDPC_M, FT8_LDPC_N
from ..protocol.parity_tables import LDPC_MN, LDPC_NM

# --- Static index tables -----------------------------------------------------
_NM = LDPC_NM.copy()                     # (83, 7) var indices, -1 pad
_NM_VALID = _NM >= 0

_MN = LDPC_MN.copy()                     # (174, 3) check indices

# Position of check m within MN[n] for each (m, j) with n = NM[m, j].
_NM_POS = np.zeros_like(_NM)
for m in range(FT8_LDPC_M):
    for j in range(7):
        n = _NM[m, j]
        if n >= 0:
            _NM_POS[m, j] = int(np.where(_MN[n] == m)[0][0])

# --- One-hot selection matrices: gathers become matmuls ----------------------
# Every per-edge gather/scatter of the Tanner graph is expressed as
# multiplication by a static 0/1 matrix over the 581-slot (check m, slot j)
# edge layout (the GPU kernel in ops/ldpc_pallas.py uses index loads).
_EDGES = FT8_LDPC_M * 7                     # 581 padded edge slots

# E (N,174) @ _SEL_VAR2EDGE (174,581) -> per-edge variable values
_SEL_VAR2EDGE = np.zeros((FT8_LDPC_N, _EDGES), np.float32)
# tov flat (N,522) @ _SEL_TOV2EDGE (522,581) -> per-edge tov[n, pos(m)]
_SEL_TOV2EDGE = np.zeros((FT8_LDPC_N * 3, _EDGES), np.float32)
for m in range(FT8_LDPC_M):
    for j in range(7):
        n = _NM[m, j]
        if n >= 0:
            _SEL_VAR2EDGE[n, m * 7 + j] = 1.0
            _SEL_TOV2EDGE[n * 3 + _NM_POS[m, j], m * 7 + j] = 1.0
# edge excl (N,581) @ _SEL_EDGE2TOV (581,522) -> tov'[n, i]
_SEL_EDGE2TOV = _SEL_TOV2EDGE.T.copy()
# [post, tov] (N,696) @ _SEL_V2E_COMBINED (696,581) -> post[n] - tov[n,pos]
# per edge in ONE GEMM (each output column has exactly two +/-1 entries)
_SEL_V2E_COMBINED = np.concatenate([_SEL_VAR2EDGE, -_SEL_TOV2EDGE], axis=0)
# parity counting: hard (N,174) @ _SEL_VAR2CHECK (174,83) -> ones per check
_SEL_VAR2CHECK = np.zeros((FT8_LDPC_N, FT8_LDPC_M), np.float32)
for m in range(FT8_LDPC_M):
    for j in range(7):
        if _NM[m, j] >= 0:
            _SEL_VAR2CHECK[_NM[m, j], m] = 1.0


def _fast_tanh(x):
    """Padé [3/2]-style rational tanh — the same approximation ft8_lib's
    bp_decode uses (fast_tanh in kgoba decode.c), and cheaper than the
    exact transcendental."""
    x = jnp.clip(x, -4.97, 4.97)
    x2 = x * x
    return x * (945.0 + x2 * (105.0 + x2)) \
        / (945.0 + x2 * (420.0 + 15.0 * x2))


def _fast_atanh(x):
    """Rational atanh matching ft8_lib's fast_atanh; saturates instead of
    diverging near ±1, which caps message magnitudes exactly like the C."""
    x2 = x * x
    return x * (945.0 + x2 * (-735.0 + x2 * 64.0)) \
        / (945.0 + x2 * (-1050.0 + x2 * 225.0))


# The value GEMMs carry every BP message: at HIGHEST each output is one
# or two exact float32 terms, so the selection is exact (at DEFAULT a GPU
# may round the messages to TF32's 10-bit mantissa).
_MM = dict(precision=jax.lax.Precision.HIGHEST,
           preferred_element_type=jnp.float32)


@functools.partial(jax.jit,
                   static_argnames=("max_iters", "return_posterior"))
def bp_decode_xla(llr: jax.Array, max_iters: int = 20,
                  return_posterior: bool = False):
    """Decode a batch of LLR vectors (XLA loop of one-hot GEMMs).

    Args:
      llr: (..., 174) float32, positive = bit 1 (ft8_lib convention).
      max_iters: fixed BP iteration count (reference uses 20).
      return_posterior: also return the final-iteration posterior LLRs
        (..., 174) — the sharpened beliefs OSD reprocesses on BP failures.

    Returns:
      (hard, num_errors[, posterior]): (..., 174) int8 hard decisions of
      the best iteration and (...,) int32 unsatisfied-check counts
      (0 = success).
    """
    batch_shape = llr.shape[:-1]
    llr2 = llr.reshape((-1, FT8_LDPC_N))
    N = llr2.shape[0]

    sel_v2e_combined = jnp.asarray(_SEL_V2E_COMBINED)
    edge2tov = jnp.asarray(_SEL_EDGE2TOV)
    var2check = jnp.asarray(_SEL_VAR2CHECK)
    edge_valid = jnp.asarray(_NM_VALID.reshape(-1))          # (581,)

    # Derive the loop carry from the input so it inherits any shard_map
    # varying-axis types (pvary) — plain constants would mismatch the body
    # outputs when bp_decode runs inside a manual-sharding region.
    zero = llr2[:, :1] * 0.0
    tov0 = jnp.zeros((N, FT8_LDPC_N * 3), llr2.dtype) + zero
    best_err0 = jnp.full((N,), FT8_LDPC_M, jnp.int32) \
        + zero[:, 0].astype(jnp.int32)
    best_hard0 = jnp.zeros((N, FT8_LDPC_N), jnp.int8) \
        + zero.astype(jnp.int8)

    def body(_, state):
        tov, best_err, best_hard = state
        tov3 = tov.reshape(N, FT8_LDPC_N, 3)
        post = llr2 + jnp.sum(tov3, axis=-1)                 # (N, 174)
        hard = (post > 0)
        hardf = hard.astype(jnp.float32)
        # parity via GEMM: ones-per-check mod 2
        cnt = jnp.dot(hardf, var2check, **_MM)               # (N, 83)
        errors = jnp.sum(jnp.mod(cnt, 2.0), axis=-1).astype(jnp.int32)
        allzero = ~jnp.any(hard, axis=-1)
        errors = jnp.where(allzero, FT8_LDPC_M, errors)
        better = errors < best_err
        best_err = jnp.where(better, errors, best_err)
        best_hard = jnp.where(better[..., None], hard.astype(jnp.int8),
                              best_hard)

        # Variable -> check: Tnm = posterior[n] - tov[n, pos(m)] per edge,
        # as ONE concatenated GEMM: [post, tov] @ [var2edge; -tov2edge]
        pt = jnp.concatenate([post, tov], axis=-1)           # (N, 696)
        diff = jnp.dot(pt, sel_v2e_combined, **_MM)          # (N, 581)
        toc = _fast_tanh(-0.5 * diff)
        toc = jnp.where(edge_valid, toc, 1.0)
        toc7 = toc.reshape(N, FT8_LDPC_M, 7)

        # Exclusive products per check row via prefix/suffix products
        # (2*6 muls instead of 7 masked 6-term products)
        fwd = [jnp.ones_like(toc7[..., 0])]
        bwd = [jnp.ones_like(toc7[..., 0])]
        for j in range(6):
            fwd.append(fwd[-1] * toc7[..., j])
            bwd.append(bwd[-1] * toc7[..., 6 - j])
        excl = jnp.stack([fwd[j] * bwd[6 - j] for j in range(7)],
                         axis=-1).reshape(N, _EDGES)

        # Check -> variable scatter via GEMM
        val = jnp.dot(excl, edge2tov, **_MM)                 # (N, 522)
        val = jnp.clip(val, -0.999999, 0.999999)
        tov_new = -2.0 * _fast_atanh(val)
        return tov_new, best_err, best_hard

    tov_f, best_err, best_hard = jax.lax.fori_loop(
        0, max_iters, body, (tov0, best_err0, best_hard0))
    hard_out = best_hard.reshape(batch_shape + (FT8_LDPC_N,))
    err_out = best_err.reshape(batch_shape)
    if return_posterior:
        post = llr2 + jnp.sum(tov_f.reshape(N, FT8_LDPC_N, 3), axis=-1)
        return hard_out, err_out, post.reshape(batch_shape + (FT8_LDPC_N,))
    return hard_out, err_out


# --- CRC-14 as a GF(2) matrix (batched check) --------------------------------
def _crc_matrix():
    from ..protocol.crc import payload_crc
    mat = np.zeros((77, 14), dtype=np.int32)
    base = np.zeros(77, dtype=np.uint8)
    c0 = payload_crc(base)
    for i in range(77):
        v = base.copy(); v[i] = 1
        c = payload_crc(v) ^ c0
        mat[i] = [(c >> (13 - b)) & 1 for b in range(14)]
    assert c0 == 0
    return mat

_CRC_MAT = _crc_matrix()


def crc_check(hard91: jax.Array) -> jax.Array:
    """Vectorized CRC-14 check on (..., >=91) hard bits; True = CRC ok."""
    payload = hard91[..., :77].astype(jnp.int32)
    expect = jnp.dot(payload, jnp.asarray(_CRC_MAT),
                     precision=jax.lax.Precision.HIGHEST) % 2
    got = hard91[..., 77:91].astype(jnp.int32)
    return jnp.all(expect == got, axis=-1)


def bp_decode(llr, max_iters: int = 20, return_posterior: bool = False):
    """bp_decode, run on a GPU by the Triton-route kernel
    (ops/ldpc_pallas.py) and elsewhere by the XLA loop above. The choice
    follows the platform the graph is lowered for, so one process can
    compile the same graph for both. FT8D_EXACT=1 keeps the XLA loop
    everywhere (the parity anchor)."""
    def xla(x):
        return bp_decode_xla(x, max_iters, return_posterior)

    if _os.environ.get("FT8D_EXACT") == "1":
        return xla(llr)
    from .ldpc_pallas import bp_decode_pallas
    return jax.lax.platform_dependent(
        llr, default=xla,
        cuda=lambda x: bp_decode_pallas(x, max_iters, return_posterior))
