"""Every matrix product on the device path names its precision: a GPU may
run an unpinned float32 dot in TF32 (10-bit mantissa)."""

import jax
import jax.numpy as jnp
import pytest


def _dots(jaxpr):
    """All dot_general equations of a jaxpr, nested jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _dots(inner)


def _stage(name):
    from rtlsdr_ft8d_jax.ops import (ap, channelize, decimate, ldpc, llr,
                                     refine, waterfall)
    from rtlsdr_ft8d_jax.pipeline import decode_window_device

    x = jnp.zeros((1, 48000), jnp.float32)
    llrs = jnp.zeros((4, 174), jnp.float32)
    cand = {k: jnp.zeros((4,), jnp.int32) for k in
            ("time_sub", "freq_sub", "time_offset", "freq_offset")}
    wf = jnp.zeros((1, 92, 2, 2, 256), jnp.uint8)
    chan = jnp.zeros((4,), jnp.int32)
    return {
        "waterfall": (waterfall.waterfall, (x, x)),
        "llr": (llr.extract_llrs_flat, (wf, cand, chan)),
        "bp": (lambda v: ldpc.bp_decode(v, 20, True), (llrs,)),
        "refine": (refine.refine_llrs_flat, (x, x, cand, chan)),
        "crc": (ldpc.crc_check, (jnp.zeros((4, 174), jnp.int8),)),
        "ap_bank": (lambda v, s: ap.bank_correlate(v, s, chan),
                    (llrs, jnp.zeros((64, 174), jnp.float32))),
        "decimate": (decimate.polyphase_decimate,
                     (jnp.zeros(decimate.HISTORY + 750 * 8),) * 2),
        "channelize": (channelize.channelize,
                       (jnp.zeros(channelize.WB_HISTORY + 750 * 4),) * 2),
        "deep_graph": (lambda a, b, s: decode_window_device(
            a, b, budget=64, osd_cands=1, ap_cq=True, ap_cw_signs=s),
            (x, x, jnp.zeros((64, 174), jnp.float32))),
    }[name]


@pytest.mark.parametrize("name", ["waterfall", "llr", "bp", "refine",
                                  "crc", "ap_bank", "decimate",
                                  "channelize", "deep_graph"])
def test_every_dot_pins_its_precision(name):
    fn, args = _stage(name)
    dots = list(_dots(jax.make_jaxpr(fn)(*args).jaxpr))
    assert dots, f"{name}: no matrix product found"
    unpinned = [str(e) for e in dots if e.params["precision"] is None]
    assert not unpinned, unpinned
