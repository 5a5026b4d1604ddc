"""The port's gossip train step against the JAX package's for the MoE
family (mixtral-8x7b reduced: the router's aux loss in the loss and its
gradient) and the enc-dec family (seamless-m4t-medium reduced: a frontend
of frames in every node's batch), at ``reduced()`` in f32.

The same holds and tolerances as tests/test_torch_lm_steps.py (state,
loss and metrics within 1e-5 over 3 steps, the reference's Laplace draws
injected), which runs the dense family's cases; this file is apart so the
reference's compilations spread over two test workers. Each family runs
the non-private step with one microbatch and no delay, and the private
step (eps = 1) with two microbatches and a delay of 2.
"""
import pytest

pytest.importorskip("torch")

from test_torch_lm_steps import gossip_case, one_thread  # noqa: E402,F401


@pytest.mark.parametrize("eps,microbatches,delay",
                         [(float("inf"), 1, 0), (1.0, 2, 2)])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "seamless-m4t-medium"])
def test_gossip_train_step_matches_the_reference_families(arch, eps,
                                                          microbatches,
                                                          delay):
    gossip_case(arch, eps, microbatches, delay)
