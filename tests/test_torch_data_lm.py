"""The port's LM token stream (`repro_torch.data.lm`) against the JAX
package's (`repro.data.lm`).

The port draws from `torch.Generator`s seeded from (seed, step, node), so
its tokens are not the reference's `jax.random` ones; the two streams are
held by distribution, as tests/test_data.py holds the reference's:
shapes, dtype, replay per (seed, step, node) and disjoint nodes; labels
shifted with the last position -1; the walk's share of transitions that
follow ``(prev * 31 + 7) % V`` within 0.05 of the reference's on the same
sizes (each share's standard error is ~0.006 at 8,128 transitions); the
Zipf marginal of first tokens by a chi-square bound (20 bins, 19 degrees
of freedom: 60 is past the 1e-6 tail) and the marginal itself within 1e-7
of the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.lm import TokenStream as JTokenStream  # noqa: E402
from repro.data.lm import lm_batches as jlm_batches  # noqa: E402

from repro_torch.data import TokenStream, lm_batches  # noqa: E402

SHIFT_TOL = 0.05
CHI2_BOUND = 60.0


def shift_share(toks: np.ndarray, V: int) -> float:
    return float((toks[:, 1:] == (toks[:, :-1] * 31 + 7) % V).mean())


def test_token_stream_shapes_dtype_and_replay():
    ts = TokenStream(vocab_size=128, seed=0, device="cpu")
    a = ts.sample(step=3, node=1, batch=4, seq=32)
    assert a.shape == (4, 32) and a.dtype == torch.int32
    assert a.device.type == "cpu"
    assert int(a.max()) < 128 and int(a.min()) >= 0
    assert torch.equal(a, ts.sample(3, 1, 4, 32))
    assert torch.equal(a, TokenStream(128, seed=0, device="cpu")
                       .sample(3, 1, 4, 32))
    # another node, step or seed is another stream
    for other in (ts.sample(3, 2, 4, 32), ts.sample(4, 1, 4, 32),
                  TokenStream(128, seed=1, device="cpu").sample(3, 1, 4, 32)):
        assert not torch.equal(a, other)


def test_node_streams_are_disjoint():
    """No two nodes' rows of one step coincide (fresh randomness per
    (step, node)), on a vocabulary large enough that chance agreement of
    a whole row is nil."""
    b = next(lm_batches(1000, batch=4, seq=24, nodes=6, seed=2,
                        device="cpu"))
    rows = b["tokens"].reshape(-1, 24).numpy()
    assert len(np.unique(rows, axis=0)) == rows.shape[0]


@pytest.mark.parametrize("nodes", [1, 3])
def test_lm_batches_labels_are_shifted(nodes):
    it = lm_batches(vocab_size=100, batch=2, seq=16, nodes=nodes,
                    device="cpu")
    jb = next(jlm_batches(vocab_size=100, batch=2, seq=16, nodes=nodes))
    b = next(it)
    lead = (nodes, 2) if nodes > 1 else (2,)
    assert tuple(b["tokens"].shape) == tuple(jb["tokens"].shape) == \
        lead + (16,)
    assert b["labels"].dtype == torch.int32 == b["tokens"].dtype
    assert str(jb["labels"].dtype) == "int32"
    np.testing.assert_array_equal(b["labels"][..., :-1].numpy(),
                                  b["tokens"][..., 1:].numpy())
    assert (b["labels"][..., -1] == -1).all()
    assert not torch.equal(b["tokens"], next(it)["tokens"])  # next step


def test_walk_follows_the_shift_as_often_as_the_reference():
    """About half the transitions follow the learnable rule, in both
    packages (tests/test_data.py asks > 0.3 of the reference)."""
    V = 64
    toks = TokenStream(V, seed=0, device="cpu").sample(0, 0, 64, 128)
    jtoks = np.asarray(JTokenStream(V, seed=0).sample(0, 0, 64, 128))
    share, jshare = shift_share(toks.numpy(), V), shift_share(jtoks, V)
    assert 0.45 < share < 0.65 and 0.45 < jshare < 0.65
    assert abs(share - jshare) <= SHIFT_TOL, (share, jshare)


def test_first_tokens_follow_the_zipf_marginal():
    V, n = 1000, 20_000
    ts = TokenStream(V, seed=4, device="cpu")
    p = ts._marginal().numpy()
    np.testing.assert_allclose(p, np.asarray(JTokenStream(V)._marginal()),
                               rtol=1e-6, atol=1e-7)
    first = ts.sample(0, 0, n, 1)[:, 0].numpy()
    counts = np.bincount(first, minlength=V)
    obs = np.append(counts[:19], counts[19:].sum())
    exp = n * np.append(p[:19], p[19:].sum())
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert chi2 < CHI2_BOUND, chi2


def test_the_stream_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenStream(100).sample(0, 0, 2, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(lm_batches(100, batch=2, seq=4))
