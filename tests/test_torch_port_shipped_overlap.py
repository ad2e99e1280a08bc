"""``build_shipped_model("superglue", with_overlap=True)``: SuperPoint and
SuperGlue behind the trained OETR gate, the port's (read without orbax)
against JAX's on the CPU, at the bounds of ``test_torch_port_shipped.py``
(its ``check_shipped_pipeline``)."""
from test_torch_port_shipped import check_shipped_pipeline


def test_shipped_superglue_with_overlap_matches_jax():
    check_shipped_pipeline("superglue", True)
