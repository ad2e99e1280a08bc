"""``build_shipped_model("loftr")`` with and without the trained OETR
gate, the port's (read without orbax) against JAX's on the CPU, at the
bounds of ``test_torch_port_shipped.py`` (its ``check_shipped_pipeline``).
"""
import pytest

from test_torch_port_shipped import check_shipped_pipeline


@pytest.mark.parametrize("with_overlap", [False, True])
def test_shipped_loftr_matches_jax(with_overlap):
    check_shipped_pipeline("loftr", with_overlap)
