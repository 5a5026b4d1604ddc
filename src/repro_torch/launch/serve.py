"""Serving launcher: online predictions while gossip training advances.

Counterpart of `repro.launch.serve`, on the port (CUDA unless ``--device
cpu``):

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --nodes 8 --dim 64 \\
        --horizon 2048 --chunk-rounds 64 --ticks 512 --json serve.json

Stands up a `repro_torch.serve.ServeService` (background gossip trainer +
admission/batching front end), replays the `bursty` stream's heavy-tailed
arrival process against it, then:

  * verifies a served response is BIT-IDENTICAL to a fresh
    `repro_torch.run` at the recorded snapshot round (the publication
    contract),
  * demonstrates eps-exhaustion refusal under sequential composition with a
    finite budget,
  * prints (and optionally writes) the latency / QPS / staleness summary
    (staleness in rounds of publication lag, and the served snapshot's age
    in milliseconds, which grows while the trainer stalls).

>>> out = demo_refusal(device="cpu")
>>> out["exhausted"], out["refused_status"], out["last_round"]
(True, 'refused', 8)
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.api.spec import RunSpec
from repro_torch.serve import BurstyReplay, ServeConfig, ServeService

__all__ = ["serve_social", "demo_refusal", "main"]


def demo_refusal(*, nodes: int = 2, dim: int = 8, horizon: int = 32,
                 eps: float = 1.0, eps_budget: float = 10.0,
                 chunk_rounds: int = 4, timeout_s: float = 120.0,
                 device: str = "cuda") -> dict:
    """Train under sequential composition until the eps budget is spent,
    then show the service refuses a request."""
    spec = RunSpec(nodes=nodes, dim=dim, horizon=horizon, eps=eps,
                   alpha0=0.5, lam=0.01, stream="bursty", backend="cuda")
    svc = ServeService(ServeConfig(
        spec=spec, chunk_rounds=chunk_rounds, composition="sequential",
        eps_budget=eps_budget, max_batch=4, max_wait_ms=0.5,
        warmup=False, device=device)).start()
    deadline = time.perf_counter() + timeout_s
    while not svc.exhausted() and time.perf_counter() < deadline:
        time.sleep(0.01)
    refused = svc.submit([1.0] * dim, node=0).wait(timeout_s)
    svc.stop(timeout_s)
    out = {
        "eps_budget": eps_budget,
        "eps_spent": svc.eps_spent(),
        "exhausted": svc.exhausted(),
        "refused_status": refused.status,
        "last_round": svc.state.current.round,
    }
    if not out["exhausted"] or out["refused_status"] != "refused":
        raise RuntimeError(f"eps-exhaustion refusal failed: {out}")
    return out


def serve_social(*, nodes: int = 8, dim: int = 32, horizon: int = 512,
                 eps: float = 10.0, engine: str = "sim", mode: str = "node",
                 chunk_rounds: int = 32, max_batch: int = 32,
                 max_wait_ms: float = 1.0, queue_capacity: int = 1024,
                 ticks: int = 256, rate_ticks_per_s: float | None = None,
                 checkpoint_dir: str | None = None, verify: bool = True,
                 warmup: bool = True, timeout_s: float = 300.0,
                 device: str = "cuda") -> dict:
    """Replay a bursty workload against a live training service; return the
    end-to-end summary (and verify one response against a fresh run)."""
    spec = RunSpec(nodes=nodes, dim=dim, horizon=horizon, eps=eps,
                   alpha0=0.5, lam=0.01, stream="bursty", backend="cuda")
    cfg = ServeConfig(spec=spec, engine=engine, mode=mode,
                      chunk_rounds=chunk_rounds, max_batch=max_batch,
                      max_wait_ms=max_wait_ms, queue_capacity=queue_capacity,
                      checkpoint_dir=checkpoint_dir, warmup=warmup,
                      # keep every publication so verify() can always find
                      # the sampled response's snapshot in the history ring
                      keep_snapshots=max(horizon // chunk_rounds + 2, 8),
                      device=device)
    svc = ServeService(cfg).start()
    replay = BurstyReplay(spec.resolve_stream(device=svc.device))
    drive = replay.drive(svc, 0, min(ticks, horizon),
                         rate_ticks_per_s=rate_ticks_per_s,
                         timeout_s=timeout_s)
    svc.stop(timeout_s)

    verified = None
    if verify:
        # last-served request: its snapshot is the most recent, so it is
        # still inside the keep_snapshots history ring
        served = [r for r in drive["requests"] if r.status == "ok"]
        sample = max(served, key=lambda r: (r.snapshot_version or 0))
        verified = svc.verify(sample)
        if not verified:
            raise RuntimeError(
                "served prediction did not match the model of a fresh run "
                f"at snapshot round {sample.snapshot_round}")

    stats = svc.stats()
    drive.pop("requests")
    return {
        "spec": {"nodes": nodes, "dim": dim, "horizon": horizon, "eps": eps,
                 "engine": engine, "mode": mode,
                 "chunk_rounds": chunk_rounds,
                 "device": str(svc.device)},
        "replay": drive,
        "admission": stats["admission"],
        "serving": stats["serving"],
        "snapshot_age_ms": svc.stats_.snapshot_age_ms(),
        "snapshot_identical": verified,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--horizon", type=int, default=512)
    ap.add_argument("--eps", type=float, default=10.0)
    ap.add_argument("--engine", choices=("sim", "dist"), default="sim")
    ap.add_argument("--mode", choices=("node", "average"), default="node")
    ap.add_argument("--chunk-rounds", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=1.0)
    ap.add_argument("--queue-capacity", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=256)
    ap.add_argument("--rate", type=float, default=None,
                    help="replay pacing in ticks/s (default: open throttle)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--json", dest="json_path", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the trainer and the predictor run (cpu: "
                         "the kernels' plain PyTorch versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="small spec + refusal demo; exercises every "
                         "acceptance path in seconds")
    args = ap.parse_args(argv)

    if args.smoke:
        summary = serve_social(
            nodes=4, dim=16, horizon=96, eps=10.0, engine=args.engine,
            mode=args.mode, chunk_rounds=8, max_batch=8, max_wait_ms=0.5,
            queue_capacity=256, ticks=64, warmup=False, device=args.device)
        summary["refusal"] = demo_refusal(device=args.device)
    else:
        summary = serve_social(
            nodes=args.nodes, dim=args.dim, horizon=args.horizon,
            eps=args.eps, engine=args.engine, mode=args.mode,
            chunk_rounds=args.chunk_rounds, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            queue_capacity=args.queue_capacity, ticks=args.ticks,
            rate_ticks_per_s=args.rate, checkpoint_dir=args.checkpoint_dir,
            device=args.device)

    adm, rep = summary["admission"], summary["replay"]
    age = summary["snapshot_age_ms"]
    print(f"replayed {rep['submitted']} requests over {rep['ticks']} ticks: "
          f"{rep['served']} served / {rep['shed']} shed / "
          f"{rep['refused']} refused at {rep['qps']:.0f} qps "
          f"on {summary['spec']['device']}")
    print(f"latency p50={adm['p50_latency_ms']}ms "
          f"p99={adm['p99_latency_ms']}ms  staleness "
          f"mean={adm['staleness_mean_rounds']} "
          f"max={adm['staleness_max_rounds']} rounds (publication lag)  "
          f"snapshot age mean={age['mean']}ms max={age['max']}ms")
    print(f"snapshot bit-identical to a fresh run: "
          f"{summary['snapshot_identical']}")
    if "refusal" in summary:
        r = summary["refusal"]
        print(f"eps budget {r['eps_budget']} spent at round {r['last_round']}"
              f" -> request {r['refused_status']}")
    if args.json_path:
        with open(args.json_path, "w") as fh:
            json.dump(summary, fh, indent=2, sort_keys=True)
        print(f"wrote {args.json_path}")
    return summary


if __name__ == "__main__":
    main()
