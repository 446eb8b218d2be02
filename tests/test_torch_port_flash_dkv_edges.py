"""The port's plain flash forward and backward against the JAX ``_fwd_impl``
and ``_bwd_impl`` (Pallas in interpret mode) at the edges of the bf16 dk/dv
kernel (``dkv_sm90``) that tests/test_torch_port_flash_edges.py does not
straddle: sep one past the first 64-key half of its 128-key tile (65) and at
the second tile's halves (192), both variants at T = 257; and the prefix
variant with Tq one short of, at and one past a 64-row query tile (63, 64,
65) against Tk = 257, with a nonzero dlse. chip_smoke.py adds the same edges
to its backward grid (``DKV_EDGES``), against these plain versions.
Tolerance: atol = rtol = 1e-4, as tests/torch_port_flash_cases.py sets it.
"""

import pytest

from torch_port_flash_cases import check_plain_backward

DKV_EDGES = [(257, 65), (257, 192)]


@pytest.mark.parametrize("include_diag", [True, False], ids=["diag", "prefix"])
@pytest.mark.parametrize("T,sep", DKV_EDGES)
def test_plain_backward_matches_jax_at_dkv_key_edges(T, sep, include_diag):
    check_plain_backward(T, sep, include_diag)


@pytest.mark.parametrize("Tq", [63, 64, 65])
@pytest.mark.parametrize("T,sep", DKV_EDGES)
def test_plain_prefix_backward_matches_jax_across_a_query_tile_edge(T, sep, Tq):
    check_plain_backward(T, sep, False, Tq=Tq)
