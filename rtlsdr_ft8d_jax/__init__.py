"""Batched FT8 decoding in JAX."""

import os

# What replaced each variable of the package's former `FT8_<name>_`
# environment prefix; the others were removed with the code they chose.
_RENAMED = {"EXACT": "FT8D_EXACT", "REQUIRE_NATIVE": "FT8D_REQUIRE_NATIVE",
            "NATIVE_SO": "FT8D_NATIVE_SO"}


def check_environment(environ=os.environ):
    """Refuse variables of the former prefix. Ignored, they would change
    behaviour silently: FT8_<name>_REQUIRE_NATIVE=1 would no longer stop
    the Python fallback it was set to forbid."""
    old = sorted(k for k in environ if k.startswith("FT8_"))
    if not old:
        return
    lines = []
    for key in old:
        new = _RENAMED.get(key.split("_", 2)[-1])
        lines.append(f"  {key}: " + (f"use {new}" if new else
                                     "removed, nothing replaces it"))
    raise RuntimeError("environment variables of the former FT8_<name>_ "
                       "prefix are no longer read; unset them:\n"
                       + "\n".join(lines))


check_environment()
