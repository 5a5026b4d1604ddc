"""The port's round kernels (plain versions) against the Pallas kernels.

`repro_torch.kernels.round_fused` holds three hand-written CUDA kernels and,
beside each, its plain PyTorch version. The CUDA kernels run only on a card
(``chip_smoke.py`` holds them against the plain versions there); here, on
the CPU, each wrapper computes its plain version, and that is held against
`repro.kernels.round_fused.<kernel>(..., interpret=True)` on the same
inputs, at the odd shapes of tests/test_backends.py. The Pallas kernels take
(8, 128)-padded blocks, so their inputs are zero-padded and their outputs
cut back; the port's kernels mask ragged edges themselves.

Tolerances: ``nnz`` is a count and must match exactly; float outputs within
rtol=atol=1e-5, as tests/test_backends.py holds the Pallas kernels to their
jnp oracles (the two sides reduce in different orders).

``round_update``'s sparse path takes A's CSR form (`MixCSR`); its tests here
check that form against the graph's dense A, exactly, and that the wrapper
refuses a malformed one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import round_fused as jrf  # noqa: E402
from repro_torch.core.graph import SparseGraph, ring_edges  # noqa: E402
from repro_torch.kernels import round_fused as rf  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _pad(a: np.ndarray, m_pad: int, n_pad: int | None = None):
    if a.ndim == 1:
        return jnp.asarray(np.pad(a, (0, m_pad - a.shape[0])))
    return jnp.asarray(np.pad(a, ((0, m_pad - a.shape[0]),
                                  (0, n_pad - a.shape[1]))))


def _t(a: np.ndarray):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("prox_l1", [True, False])
@pytest.mark.parametrize("m,n", [(3, 40), (8, 128), (10, 200), (6, 1025),
                                 (17, 64)])
def test_round_stats_matches_pallas(m, n, prox_l1):
    rng = np.random.default_rng(m * n)
    theta = rng.standard_normal((m, n)).astype(np.float32)
    x = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    lam_t = 0.37
    m_pad, n_pad = jrf._pad_rows(m), jrf._pad_cols(n)
    want = jrf.round_stats(_pad(theta, m_pad, n_pad), _pad(x, m_pad, n_pad),
                           jnp.float32(lam_t), m, prox_l1=prox_l1,
                           interpret=True)
    dot, xsq, nnz, wbdot, wsum = rf.round_stats(_t(theta), _t(x), lam_t, m,
                                                prox_l1=prox_l1)
    assert nnz.dtype == torch.int32
    np.testing.assert_array_equal(nnz.numpy(),
                                  np.asarray(want[2][:m]).astype(np.int32))
    for got, ref in ((dot, want[0]), (xsq, want[1]), (wbdot, want[3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[:m]), **TOL)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(want[4][:n]), **TOL)


@pytest.mark.parametrize("mix", ["softmax", "ring"])
@pytest.mark.parametrize("noise_self", [True, False])
@pytest.mark.parametrize("use_recv", [0, 1])
@pytest.mark.parametrize("m,n", [(4, 40), (10, 130)])
def test_round_update_matches_pallas(m, n, use_recv, noise_self, mix):
    """A dense softmax A (the dense path), or the main path's ring with its
    CSR form handed to the wrapper (the sparse path on a card)."""
    rng = np.random.default_rng(7 * m + n)
    theta = rng.standard_normal((m, n)).astype(np.float32)
    delta = (0.1 * rng.standard_normal((m, n))).astype(np.float32)
    x = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    recv = rng.standard_normal((m, n)).astype(np.float32)
    coeff = rng.standard_normal(m).astype(np.float32)
    csr = None
    if mix == "ring":
        A = ring_edges(m).to_dense()
        csr = rf.sparse_mix(ring_edges(m), "cpu")
        assert csr is not None
    else:
        logits = rng.standard_normal((m, m))
        A = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
            np.float32)
    diag = np.ascontiguousarray(np.diagonal(A))
    alive = np.ones(m, np.float32)
    alive[1] = 0.0
    m_pad, n_pad = jrf._pad_rows(m), jrf._pad_cols(n)
    want_next, want_tilde = jrf.round_update(
        _pad(A, m_pad, m_pad), _pad(theta, m_pad, n_pad),
        _pad(delta, m_pad, n_pad), _pad(x, m_pad, n_pad),
        _pad(recv, m_pad, n_pad), _pad(coeff, m_pad), _pad(diag, m_pad),
        _pad(alive, m_pad), jnp.float32(0.25), jnp.float32(use_recv),
        noise_self, interpret=True)
    got_next, got_tilde = rf.round_update(
        _t(A), _t(theta), _t(delta), _t(x), _t(recv), _t(coeff), _t(diag),
        _t(alive), 0.25, use_recv, noise_self, csr=csr)
    np.testing.assert_allclose(got_next.numpy(),
                               np.asarray(want_next[:m, :n]), **TOL)
    np.testing.assert_allclose(got_tilde.numpy(),
                               np.asarray(want_tilde[:m, :n]), **TOL)
    # the frozen row keeps theta exactly
    np.testing.assert_array_equal(got_next.numpy()[1], theta[1])


@pytest.mark.parametrize("m,n", [(5, 40), (8, 384), (9, 300)])
def test_dual_step_matches_pallas(m, n):
    rng = np.random.default_rng(m + n)
    mixed, x, theta = (rng.standard_normal((m, n)).astype(np.float32)
                       for _ in range(3))
    coeff = rng.standard_normal(m).astype(np.float32)
    alive = np.ones(m, np.float32)
    alive[0] = 0.0
    m_pad, n_pad = jrf._pad_rows(m), jrf._pad_cols(n)
    want = jrf.dual_step(_pad(mixed, m_pad, n_pad), _pad(x, m_pad, n_pad),
                         _pad(theta, m_pad, n_pad), _pad(coeff, m_pad),
                         _pad(alive, m_pad), jnp.float32(0.5), interpret=True)
    got = rf.dual_step(_t(mixed), _t(x), _t(theta), _t(coeff), _t(alive),
                       0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[:m, :n]), **TOL)
    np.testing.assert_array_equal(got.numpy()[0], theta[0])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rf.reset_launches()
    rng = np.random.default_rng(0)
    theta, x = (_t(rng.standard_normal((3, 50))) for _ in range(2))
    got = rf.round_stats(theta, x, 0.1, 3)
    want = rf.round_stats_plain(theta, x, 0.1, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (rf.round_stats.launches, rf.round_update.launches,
            rf.dual_step.launches) == (0, 0, 0)


@pytest.mark.parametrize("bad,err", [
    (lambda t: t.double(), TypeError),
    (lambda t: t[:, :-1], ValueError),
    (lambda t: t.t().contiguous().t(), ValueError),   # non-contiguous
    (lambda t: t.to("meta"), ValueError),             # other device
])
def test_wrappers_reject_what_the_kernels_do_not_take(bad, err):
    theta = torch.zeros((4, 8))
    with pytest.raises(err):
        rf.round_stats(theta, bad(torch.zeros((4, 8))), 0.1, 4)
    with pytest.raises(err):
        rf.dual_step(theta, bad(torch.zeros((4, 8))), theta,
                     torch.zeros(4), torch.ones(4), 0.1)
    A, v = torch.eye(4), torch.zeros(4)
    with pytest.raises(err):
        rf.round_update(A, theta, bad(torch.zeros((4, 8))), theta, theta,
                        v, v, v, 0.1, 0, True)


def _irregular_graph() -> SparseGraph:
    """Unsorted edges with duplicate pairs, an isolated row and rows of
    different lengths."""
    rng = np.random.default_rng(3)
    dst = rng.integers(0, 9, 40)
    dst = dst[dst != 4]
    src = rng.integers(0, 9, dst.size)
    w = rng.random(dst.size).astype(np.float32)
    return SparseGraph(dst=np.concatenate([dst, dst[:5]]),
                       src=np.concatenate([src, src[:5]]),
                       weight=np.concatenate([w, w[:5]]), m=9)


@pytest.mark.parametrize("graph", [ring_edges(1), ring_edges(2),
                                   ring_edges(3), ring_edges(64),
                                   _irregular_graph()],
                         ids=["ring1", "ring2", "ring3", "ring64",
                              "irregular"])
def test_csr_form_holds_the_dense_non_zeros_in_column_order(graph):
    csr = rf.MixCSR.from_graph(graph, "cpu")
    A = graph.to_dense()
    m = A.shape[0]
    assert csr.m == m
    assert (csr.indptr.dtype, csr.indices.dtype, csr.weights.dtype) == (
        torch.int32, torch.int32, torch.float32)
    ptr, idx, w = (t.numpy() for t in (csr.indptr, csr.indices,
                                       csr.weights))
    assert ptr[0] == 0 and ptr[-1] == idx.size
    rebuilt = np.zeros_like(A)
    for i in range(m):
        cols = idx[ptr[i]:ptr[i + 1]]
        assert np.all(np.diff(cols) > 0)          # ascending, merged
        rebuilt[i, cols] = w[ptr[i]:ptr[i + 1]]
    np.testing.assert_array_equal(rebuilt, A)     # exactly A's values


def test_sparse_mix_takes_few_non_zeros_per_row_only():
    ring = rf.sparse_mix(ring_edges(64), "cpu")
    assert int(np.diff(ring.indptr.numpy()).max()) == 3
    m = rf.SPARSE_MAX_ROW_NNZ + 1
    full = SparseGraph(dst=np.repeat(np.arange(m), m),
                       src=np.tile(np.arange(m), m),
                       weight=np.full(m * m, 1.0 / m, np.float32), m=m)
    assert rf.sparse_mix(full, "cpu") is None
    assert rf.sparse_mix(ring_edges(rf.SPARSE_MAX_NODES + 1), "cpu") is None


def _ring_csr_parts(m: int = 4):
    csr = rf.MixCSR.from_graph(ring_edges(m), "cpu")
    return csr.indptr, csr.indices, csr.weights


@pytest.mark.parametrize("bad,err", [
    (lambda p, i, w: (p, i.long(), w), TypeError),            # dtype
    (lambda p, i, w: (p, i, w.double()), TypeError),
    (lambda p, i, w: (p, i, w[:-1]), ValueError),             # shape
    (lambda p, i, w: (p.reshape(1, -1), i, w), ValueError),
    (lambda p, i, w: (p, i, w.to("meta")), ValueError),       # device
    (lambda p, i, w: (torch.cat([p[:-1], p[-1:] - 1]), i, w),  # end != nnz
     ValueError),
    (lambda p, i, w: (p, i.flip(0).contiguous(), w), ValueError),  # order
])
def test_malformed_csr_is_refused(bad, err):
    with pytest.raises(err):
        rf.MixCSR(*bad(*_ring_csr_parts()))


def test_round_update_refuses_a_csr_that_does_not_fit():
    m, n = 4, 8
    theta, v = torch.zeros((m, n)), torch.zeros(m)
    A = torch.eye(m)
    args = (A, theta, theta, theta, theta, v, v, v, 0.1, 0, True)
    with pytest.raises(TypeError):            # not a MixCSR
        rf.round_update(*args, csr=_ring_csr_parts(m))
    with pytest.raises(ValueError):           # other m
        rf.round_update(*args, csr=rf.MixCSR.from_graph(ring_edges(5),
                                                        "cpu"))
    with pytest.raises(ValueError):           # other device
        rf.round_update(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                          for a in args),
                        csr=rf.MixCSR.from_graph(ring_edges(m), "cpu"))
