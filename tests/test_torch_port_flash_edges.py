"""The port's plain flash forward and backward against the JAX
``_fwd_impl`` and ``_bwd_impl`` (Pallas in interpret mode) at the tile edges
of the sm_90a kernels: T in {255, 257} around two 128-row tiles, sep in {127,
128, 129} around a 128-key tile edge; both variants, the prefix one with
Tq != Tk and a nonzero dlse. These plain versions are the golds that
chip_smoke.py holds the kernels to on the card. Tolerance: atol = rtol =
1e-4, as tests/torch_port_flash_cases.py sets it.

The cases live in a file of their own so that each flash test file stays
well inside its share of the tier-1 run.
"""

import pytest

from torch_port_flash_cases import EDGE_CASES, check_plain_backward


@pytest.mark.parametrize("include_diag", [True, False], ids=["diag", "prefix"])
@pytest.mark.parametrize("T,sep", EDGE_CASES)
def test_plain_forward_and_backward_match_jax_at_tile_edges(T, sep, include_diag):
    check_plain_backward(T, sep, include_diag)
