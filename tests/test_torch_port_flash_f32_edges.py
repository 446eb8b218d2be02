"""The port's plain flash forward and backward against the JAX ``_fwd_impl``
and ``_bwd_impl`` (Pallas in interpret mode) at the edges of the f32 bodies
that the cases of tests/torch_port_flash_cases.py and
tests/test_torch_port_flash_dkv_edges.py do not straddle. ``fwd_f32`` takes
64-row query tiles below T = 256 and 128-row ones from there on, over 64-key
KV tiles; ``dkv_f32`` takes 64-key units and 64-row query steps. The cases:
T and sep one short of, at and one past 64, both variants; T one past three
128-row tiles (385) with sep one past four 64-key tiles (257), both
variants; and the prefix variant with Tq one short of, at and one past 256,
where the forward changes its tile height, against Tk = 385, with a nonzero
dlse. chip_smoke.py adds these edges, and T 383/384 at sep 255/256, to its
forward and backward grids (``F32_EDGES``, ``F32_PREFIX_TQ``), against these
plain versions. Tolerance: atol = rtol = 1e-4, as
tests/torch_port_flash_cases.py sets it.
"""

import pytest

from torch_port_flash_cases import check_plain_backward

F32_EDGES = [(63, 62), (64, 63), (65, 64), (385, 257)]
F32_PREFIX_EDGE, F32_PREFIX_TQ = (385, 257), [255, 256, 257]


@pytest.mark.parametrize("include_diag", [True, False], ids=["diag", "prefix"])
@pytest.mark.parametrize("T,sep", F32_EDGES)
def test_plain_forward_and_backward_match_jax_at_f32_tile_edges(T, sep, include_diag):
    check_plain_backward(T, sep, include_diag)


@pytest.mark.parametrize("Tq", F32_PREFIX_TQ)
def test_plain_prefix_backward_matches_jax_across_the_forward_tile_switch(Tq):
    check_plain_backward(*F32_PREFIX_EDGE, False, Tq=Tq)
