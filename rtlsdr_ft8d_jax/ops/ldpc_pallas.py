"""LDPC(174,91) sum-product BP as one Pallas kernel on the Triton route.

The XLA bp_decode (ops/ldpc.py) runs `max_iters` serial iterations of
one-hot selection GEMMs plus elementwise work; XLA cannot fuse across
iterations, so every iteration is several launches and a round trip of
the (N, 581) edge messages through device memory. This kernel runs the
whole loop for a block of candidates in one program, and replaces every
selection GEMM by an index load over the Tanner graph (3 checks per
variable, 6-7 variables per check, protocol/parity_tables.py). The
loads are exact, so the kernel's arithmetic is the XLA path's at
HIGHEST precision, in the same order.

Per program, state lives in two small scratch blocks (4.5 KB per
candidate), written and read back within the program. The Triton route
has no scratch memory, so they are two extra outputs of the call in
device memory (n_pad x 1280 float32, 39 MB at N=7680), discarded after
it:

  c2v  (BLOCK, 8*128): check->variable messages, slot-major — column
       j*128 + m is slot j of check m (slots 7 and checks >= 83 are
       padding and stay zero);
  post (BLOCK, 256):   variable posteriors (variables >= 174 padding).

One iteration: gather each variable's 3 incoming messages from c2v
(posterior), store it, gather it back per check slot (parity count and
variable->check messages), update the messages per check row with
prefix/suffix exclusive products, store them. Block barriers separate
every store from the loads that read it. Nothing carries across
programs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from ..protocol.constants import FT8_LDPC_M, FT8_LDPC_N
from .ldpc import _MN, _NM, _NM_POS, _fast_atanh, _fast_tanh

# Candidates and warps per program, measured on one H100
# (scripts/profile_bp.py --sweep; PERF.md): 4 candidates on 8 warps was
# fastest at N=1024 and N=7680, and N=1024 still makes 256 programs for
# the 132 SMs. Blocks of 32 spill registers and compile for minutes.
# Software pipelining has nothing to overlap (every iteration's loads
# read the previous iteration's stores), so the kernel uses one stage.
BLOCK = 4
NUM_WARPS = 8
VARS = 256                # 174 variables, padded to a power of two
CHECKS = 128              # 83 checks, padded
SLOTS = 8                 # 7 slots per check, padded
_ZERO_SLOT = 7 * CHECKS   # a c2v column that is never written

# nm[j, m]: variable on slot j of check m (VARS - 1 where the slot is
# padding; masked out by `valid` below)
_NM_IDX = np.full((SLOTS, CHECKS), VARS - 1, np.int32)
# mn[k, n]: c2v column of variable n's k-th check (zero slot for padding)
_MN_IDX = np.full((4, VARS), _ZERO_SLOT, np.int32)
for _m in range(FT8_LDPC_M):
    for _j in range(7):
        _n = _NM[_m, _j]
        if _n >= 0:
            _NM_IDX[_j, _m] = _n
            _MN_IDX[_NM_POS[_m, _j], _n] = _j * CHECKS + _m
assert all(_MN_IDX[k, n] // CHECKS < 7
           and _MN_IDX[k, n] % CHECKS == _MN[n, k]
           for k in range(3) for n in range(FT8_LDPC_N))


def _bp_kernel(llr_ref, nm_ref, mn_ref, hard_ref, err_ref, *rest,
               max_iters, with_posterior, barrier):
    if with_posterior:
        post_out_ref, c2v_ref, post_ref = rest
    else:
        c2v_ref, post_ref = rest
    bn = llr_ref.shape[0]
    llr = llr_ref[...]                                       # (bn, VARS)
    rows_v = jax.lax.broadcasted_iota(jnp.int32, (bn, VARS), 0)
    rows_c = jax.lax.broadcasted_iota(jnp.int32, (bn, CHECKS), 0)
    mn = [jnp.broadcast_to(mn_ref[k, :][None, :], (bn, VARS))
          for k in range(3)]
    nm = [jnp.broadcast_to(nm_ref[j, :][None, :], (bn, CHECKS))
          for j in range(7)]
    valid = [i < FT8_LDPC_N for i in nm]

    def slot(j):
        return (slice(None), pl.ds(j * CHECKS, CHECKS))

    def posterior():
        g = [c2v_ref[rows_v, mn[k]] for k in range(3)]
        return llr + ((g[0] + g[1]) + g[2])

    c2v_ref[...] = jnp.zeros((bn, SLOTS * CHECKS), jnp.float32)
    barrier()

    def body(_, carry):
        best_err, best_hard = carry
        post = posterior()
        hard = (post > 0.0).astype(jnp.int32)
        post_ref[...] = post
        barrier()
        pe = [post_ref[rows_c, nm[j]] for j in range(7)]     # (bn, CHECKS)
        cnt = sum(jnp.where(valid[j] & (pe[j] > 0.0), 1, 0)
                  for j in range(7))
        err = jnp.sum(cnt & 1, axis=1)
        err = jnp.where(jnp.sum(hard, axis=1) == 0, FT8_LDPC_M, err)
        better = err < best_err
        best_err = jnp.where(better, err, best_err)
        best_hard = jnp.where(better[:, None], hard, best_hard)

        toc = [jnp.where(valid[j],
                         _fast_tanh(-0.5 * (pe[j] - c2v_ref[slot(j)])), 1.0)
               for j in range(7)]
        fwd = [None, toc[0]]
        bwd = [None, toc[6]]
        for j in range(1, 6):
            fwd.append(fwd[-1] * toc[j])
            bwd.append(bwd[-1] * toc[6 - j])
        excl = [bwd[6]] + [fwd[j] * bwd[6 - j] for j in range(1, 6)] \
            + [fwd[6]]
        new = [jnp.where(valid[j], -2.0 * _fast_atanh(
            jnp.clip(excl[j], -0.999999, 0.999999)), 0.0) for j in range(7)]
        barrier()            # every read of the old messages is done
        for j in range(7):
            c2v_ref[slot(j)] = new[j]
        barrier()
        return best_err, best_hard

    best_err, best_hard = jax.lax.fori_loop(
        0, max_iters, body,
        (jnp.full((bn,), FT8_LDPC_M, jnp.int32),
         jnp.zeros((bn, VARS), jnp.int32)))
    hard_ref[...] = best_hard.astype(jnp.int8)
    err_ref[...] = best_err
    if with_posterior:
        post_out_ref[...] = posterior()


@functools.partial(jax.jit,
                   static_argnames=("max_iters", "return_posterior",
                                    "interpret", "block", "num_warps"))
def bp_decode_pallas(llr: jax.Array, max_iters: int = 20,
                     return_posterior: bool = False,
                     interpret: bool = False, block: int = BLOCK,
                     num_warps: int = NUM_WARPS):
    """bp_decode with the whole BP loop in one Triton-route Pallas kernel.

    Same arguments and returns as ops/ldpc.bp_decode. `interpret=True`
    runs the kernel through the Pallas interpreter (tests on the CPU);
    `block` and `num_warps` exist for the tuning sweep in
    scripts/profile_bp.py."""
    from jax.experimental.pallas import triton as plt

    batch_shape = llr.shape[:-1]
    llr2 = llr.reshape((-1, FT8_LDPC_N)).astype(jnp.float32)
    n = llr2.shape[0]
    n_pad = -(-max(n, 1) // block) * block
    llr2 = jnp.pad(llr2, ((0, n_pad - n), (0, VARS - FT8_LDPC_N)))

    kern = functools.partial(
        _bp_kernel, max_iters=max_iters, with_posterior=return_posterior,
        barrier=(lambda: None) if interpret else plt.debug_barrier)
    rows = lambda w: pl.BlockSpec((block, w), lambda i: (i, 0))
    full = lambda a: pl.BlockSpec(a.shape, lambda i: (0, 0))
    nm, mn = jnp.asarray(_NM_IDX), jnp.asarray(_MN_IDX)
    # inside shard_map the outputs vary over the mesh axes llr varies over
    vma = jax.typeof(llr2).vma
    out = lambda shape, dtype: jax.ShapeDtypeStruct(shape, dtype, vma=vma)
    out_specs = [rows(VARS), pl.BlockSpec((block,), lambda i: (i,))]
    out_shape = [out((n_pad, VARS), jnp.int8), out((n_pad,), jnp.int32)]
    if return_posterior:
        out_specs.append(rows(VARS))
        out_shape.append(out((n_pad, VARS), jnp.float32))
    # per-program scratch: c2v messages and posteriors
    out_specs += [rows(SLOTS * CHECKS), rows(VARS)]
    out_shape += [out((n_pad, SLOTS * CHECKS), jnp.float32),
                  out((n_pad, VARS), jnp.float32)]
    outs = pl.pallas_call(
        kern,
        grid=(n_pad // block,),
        in_specs=[rows(VARS), full(nm), full(mn)],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        interpret=interpret,
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        name="bp_decode_triton",
    )(llr2, nm, mn)

    hard = outs[0][:n, :FT8_LDPC_N].reshape(batch_shape + (FT8_LDPC_N,))
    err = outs[1][:n].reshape(batch_shape)
    if return_posterior:
        post = outs[2][:n, :FT8_LDPC_N].reshape(batch_shape + (FT8_LDPC_N,))
        return hard, err, post
    return hard, err
