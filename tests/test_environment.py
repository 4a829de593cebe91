"""Variables of the package's former environment prefix are refused,
each named with what replaced it."""

import pytest

from rtlsdr_ft8d_jax import check_environment


@pytest.mark.parametrize("key, says", [
    ("FT8_OLD_EXACT", "use FT8D_EXACT"),
    ("FT8_OLD_REQUIRE_NATIVE", "use FT8D_REQUIRE_NATIVE"),
    ("FT8_OLD_WF_PALLAS", "removed, nothing replaces it"),
])
def test_former_prefix_is_refused(key, says):
    with pytest.raises(RuntimeError, match=f"{key}: {says}"):
        check_environment({key: "1", "PATH": "/bin"})


def test_current_variables_pass():
    check_environment({"FT8D_EXACT": "1", "FT8D_REQUIRE_NATIVE": "1"})
