"""The yardstick's frozen counts, against the port's own count of today and
against hand counts at small widths."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import work  # noqa: E402

KERNELS = ["round_stats", "round_update", "pdomd_update", "hinge_grad",
           "dual_step"]


@pytest.mark.parametrize("seeds", [1, 3])
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_work_equals_the_ports_count_at_the_paper_shape(name, seeds):
    from repro_torch.kernels.work import work as port_work
    kw = {"seeds": seeds} if name in ("round_stats", "round_update") else {}
    assert work.kernel_work(name, 64, 10_000, **kw) == port_work(
        name, 64, 10_000, **kw)


def test_round_update_sparse_equals_the_ports_count_on_the_ring():
    from repro_torch.kernels.work import work as port_work
    assert work.kernel_work("round_update", 64, 10_000, nnz=192) == \
        port_work("round_update", 64, 10_000, nnz=192)


def test_kernel_work_by_hand():
    # theta and x in (2 x 3 each); dot, xsq, nnz, wbdot (2 each) and the
    # column sum (3) out: 23 float words
    assert work.kernel_work("round_stats", 2, 3) == (92, 72)
    # A's CSR form (m + 1 + 2 nnz = 3 + 2 * 4), diag (2); theta, delta,
    # x, then coeff and alive (2 each), next and tilde out
    assert work.kernel_work("round_update", 2, 3, nnz=4)[0] == 4 * (
        (2 + 1 + 8) + 2 + (3 * 6 + 2 * 2 + 2 * 6))
    assert work.kernel_work("dual_step", 2, 3) == (4 * (18 + 4 + 6), 18)


def test_round_min_bytes_by_hand():
    # x read, theta read and written, the broadcast: 4 words a coordinate
    assert work.round_min_bytes(2, 3) == 4 * 6 * 4


def test_lm_step_flops_by_hand():
    # one layer, d 4, 2 heads of 2 (1 kv head), ff 8, vocabulary 10:
    # q,k,v,o 4 * 2 * (4 + 2) = 48, gated MLP 3 * 4 * 8 = 96, head 40
    assert work.lm_matmul_params(4, 1, 2, 1, 2, 8, 10) == 184
    flops = work.lm_step_flops(6, 3, 4, 1, 2, 1, 2, 8, 10)
    assert flops == 6 * (6 * 184 + 12 * 1 * 2 * 2 * 3)


def test_lm_step_flops_of_minicpm_8_of_40():
    # published widths, 8 layers, 4 nodes x B 2 x T 512 = 4,096 tokens
    f = work.lm_step_flops(4096, 512, 2304, 8, 36, 36, 64, 5760, 122_753)
    assert f == pytest.approx(1.9417e13, rel=1e-4)
