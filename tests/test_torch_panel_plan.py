"""The panel GEMM's planner (``repro_torch.kernels.client_conv``), on the
CPU: for the LeNet path's conv GEMMs on a 132-SM card, how the kernel
tiles the output and splits K across a thread-block cluster.

The shapes are the trainer runs' of ``chip_smoke.py`` (lenet-cifar, C=32
clients, B=32, S=19 selected): the main run's five GEMMs (the client
block over all clients, the server blocks over the S*B flattened rows)
and the fused-epilogue run's server blocks stacked over the S clients;
then shapes that call for each split count."""
import pytest

from repro_torch.kernels import client_conv as tcc

N_SMS = 132
MAIN = [(32, 32768, 75, 6), (1, 155648, 150, 16), (1, 38912, 400, 32),
        (1, 9728, 800, 64), (1, 2432, 1600, 64)]
FUSED = [(32, 32768, 75, 6), (19, 8192, 150, 16), (19, 2048, 400, 32),
         (19, 512, 800, 64), (19, 128, 1600, 64)]
# (splits, C, M, K, N): shapes whose plan splits K 1, 2, 4 and 8 ways, each
# with a ragged M and a K that is no multiple of 32 (the card tests run
# them in tests/test_torch_gpu.py)
SPLIT_GEMMS = [(1, 2, 333, 45, 40), (2, 1, 8441, 201, 64), (2, 4, 700, 140, 6),
               (4, 2, 333, 301, 40), (4, 3, 517, 270, 6), (8, 1, 250, 790, 16),
               (8, 1, 1000, 1000, 64)]
SHAPES = sorted(set(MAIN + FUSED)) + [s[1:] for s in SPLIT_GEMMS] + [
    (1, 1000, 40, 64), (3, 129, 17, 70), (1, 77, 1600, 64), (1, 1, 1, 1)]


def split_bounds(K, splits):
    """The (k0, k1) range of each split as csrc/panel_gemm.cu cuts K:
    split s takes chunks [s * n // splits, (s + 1) * n // splits) of the
    n BLOCK_K-deep chunks."""
    n = -(-K // tcc.BLOCK_K)
    return [(s * n // splits * tcc.BLOCK_K,
             min(K, (s + 1) * n // splits * tcc.BLOCK_K))
            for s in range(splits)]


def _grid(C, M, N, plan):
    block_m, block_n, splits = plan
    return -(-M // block_m) * -(-N // block_n) * C * splits


@pytest.mark.parametrize("C,M,K,N", SHAPES)
def test_plan_is_a_tile_the_kernel_has_and_a_power_of_two_split(C, M, K, N):
    block_m, block_n, splits = tcc.plan_panel_gemm(C, M, K, N, N_SMS)
    assert block_n in tcc.BLOCK_M and block_m == tcc.BLOCK_M[block_n]
    assert block_n >= min(N, 64)
    assert splits in (1, 2, 4, 8) and splits <= tcc.MAX_SPLITS


@pytest.mark.parametrize("C,M,K,N", SHAPES)
def test_splits_cover_k_exactly_with_two_chunks_or_more(C, M, K, N):
    splits = tcc.plan_panel_gemm(C, M, K, N, N_SMS)[2]
    bounds = split_bounds(K, splits)
    assert len(bounds) == splits
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    for (_, hi), (lo, _) in zip(bounds, bounds[1:]):
        assert hi == lo
    for lo, hi in bounds:
        assert hi > lo and lo % tcc.BLOCK_K == 0
        if splits > 1:
            assert hi - lo > tcc.BLOCK_K        # at least two chunks


@pytest.mark.parametrize("C,M,K,N", SHAPES)
def test_grid_fills_the_card_wherever_k_allows(C, M, K, N):
    plan = tcc.plan_panel_gemm(C, M, K, N, N_SMS)
    chunks = -(-K // tcc.BLOCK_K)
    deepest = plan[2] == tcc.MAX_SPLITS or chunks < 4 * plan[2]
    assert _grid(C, M, N, plan) >= N_SMS or deepest


@pytest.mark.parametrize("n_sms", [1, N_SMS])
@pytest.mark.parametrize("C,M,K,N", SHAPES)
def test_no_split_when_the_unsplit_grid_fills_the_card(C, M, K, N, n_sms):
    block_m, block_n, splits = tcc.plan_panel_gemm(C, M, K, N, n_sms)
    if _grid(C, M, N, (block_m, block_n, 1)) >= n_sms:
        assert splits == 1


def test_path_plans():
    """The plans the LeNet path runs: the client block and server blocks
    1-2 fill the card unsplit; blocks 3 and 4 (76 and 19 tiles) split."""
    got = [tcc.plan_panel_gemm(*s, N_SMS) for s in MAIN]
    assert got == [(256, 8, 1), (256, 16, 1), (128, 32, 1), (128, 64, 4),
                   (128, 64, 8)]
    assert [tcc.plan_panel_gemm(*s, N_SMS)[2] for s in FUSED] == \
        [1, 1, 1, 4, 8]


@pytest.mark.parametrize("splits,C,M,K,N", SPLIT_GEMMS)
def test_split_shapes_plan_their_split_on_ragged_edges(splits, C, M, K, N):
    block_m, _, planned = tcc.plan_panel_gemm(C, M, K, N, N_SMS)
    assert planned == splits
    assert M % block_m and K % tcc.BLOCK_K
