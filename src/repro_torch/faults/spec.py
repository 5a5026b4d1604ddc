"""FaultSpec — declarative fault scenarios for gossip over unreliable DCNs.

Counterpart of `repro.faults.spec`, with the same fields, defaults,
validation and FAULTS registry. A `FaultSpec` names WHAT goes wrong on the
fabric; compiling it against a node count yields the
:class:`repro_torch.faults.FaultSchedule` that the faulty mixers and
engines consume. `RunSpec.faults` holds a FAULTS name (with
`RunSpec.faults_options`) or a FaultSpec instance.

The spec's ``seed`` is INDEPENDENT of ``RunSpec.seed``: the fault pattern
is part of the scenario, not of a replicate.

>>> from repro_torch.faults.spec import FAULTS, FaultSpec
>>> FaultSpec().is_zero
True
>>> FAULTS.build("links", {"link_rate": 0.1}).link_rate
0.1
>>> FAULTS.names()
('crash', 'dcn', 'links', 'none', 'partition')
>>> sched = FaultSpec(crashes=((1, 2, 5),)).compile(m=4)
>>> sched.participation(0, 8).tolist()   # node 1 dark for rounds 2, 3, 4
[8, 5, 8, 8]
"""
from __future__ import annotations

import dataclasses

from repro_torch.api.registry import Registry

__all__ = ["FaultSpec", "FAULTS"]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What goes wrong, declaratively. All fields default to "nothing".

    Link faults
        ``link_rate`` — per-round Bernoulli drop probability per undirected
        LINK (both directions share one coin, so symmetric graphs stay
        symmetric). ``partitions`` — transient splits: each
        ``(start, end, cut)`` severs every edge crossing ``node < cut``
        for rounds ``start <= t < end``.
    Crashes
        ``crashes`` — explicit ``(node, start, end)`` windows; a crashed
        node freezes its local update, spends no eps, and is masked out of
        mixing (its dropped weight heals onto neighbours' self-loops).
        ``crash_rate`` / ``crash_rounds`` — additionally draw one window
        per node with probability ``crash_rate`` at compile time (needs a
        horizon).
    Stragglers
        ``stragglers`` — explicit ``(node, extra_delay)`` pairs;
        ``straggler_rate`` / ``straggler_delay`` — seeded assignment. A
        straggler's *outgoing* broadcasts arrive ``extra_delay`` rounds
        later than the base delay, read from the history ring.
    ``seed``
        Fault PRNG seed — independent of the run seed (see module note).
    """

    link_rate: float = 0.0
    partitions: tuple = ()
    crashes: tuple = ()
    crash_rate: float = 0.0
    crash_rounds: int = 0
    stragglers: tuple = ()
    straggler_rate: float = 0.0
    straggler_delay: int = 0
    seed: int = 0
    name: str = "faults"

    def __post_init__(self):
        for field in ("link_rate", "crash_rate", "straggler_rate"):
            rate = float(getattr(self, field))
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{field} must be in [0, 1], got {rate}")
            object.__setattr__(self, field, rate)
        for field in ("crash_rounds", "straggler_delay"):
            if int(getattr(self, field)) < 0:
                raise ValueError(f"{field} must be >= 0")
        for field in ("partitions", "crashes", "stragglers"):
            rows = getattr(self, field)
            object.__setattr__(
                self, field, tuple(tuple(int(v) for v in row)
                                   for row in rows))

    @property
    def is_zero(self) -> bool:
        """True when this spec injects nothing at all."""
        return (self.link_rate == 0.0 and not self.partitions
                and not self.crashes and self.crash_rate == 0.0
                and not self.stragglers
                and (self.straggler_rate == 0.0
                     or self.straggler_delay == 0))

    def compile(self, m: int, horizon: int | None = None):
        """Resolve every data-dependent draw into a `FaultSchedule`."""
        from repro_torch.faults.schedule import FaultSchedule
        return FaultSchedule(spec=self, m=int(m), horizon=horizon)


# Build kwargs supplied by RunSpec.resolve_faults(): none — fault factories
# take only user options, so a fault scenario never inherits the run seed.
FAULTS: Registry = Registry("fault")


@FAULTS.register("none")
def _none() -> FaultSpec:
    """The explicit no-op — still runs the whole fault machinery (the
    zero-fault bit-identity scenario)."""
    return FaultSpec(name="none")


@FAULTS.register("links")
def _links(link_rate: float = 0.05, seed: int = 0) -> FaultSpec:
    """Per-round Bernoulli drops of undirected links."""
    return FaultSpec(link_rate=link_rate, seed=seed, name="links")


@FAULTS.register("partition")
def _partition(start: int = 0, end: int = 1, cut: int = 1,
               partitions: tuple = (), seed: int = 0) -> FaultSpec:
    """Transient splits of the node range at ``cut``."""
    parts = tuple(partitions) or ((start, end, cut),)
    return FaultSpec(partitions=parts, seed=seed, name="partition")


@FAULTS.register("crash")
def _crash(crash_rate: float = 0.0, crash_rounds: int = 0,
           crashes: tuple = (), seed: int = 0) -> FaultSpec:
    """Node crash windows, explicit or drawn per node."""
    return FaultSpec(crash_rate=crash_rate, crash_rounds=crash_rounds,
                     crashes=tuple(crashes), seed=seed, name="crash")


@FAULTS.register("dcn")
def _dcn(link_rate: float = 0.02, crash_rate: float = 0.05,
         crash_rounds: int = 8, straggler_rate: float = 0.1,
         straggler_delay: int = 1, seed: int = 0) -> FaultSpec:
    """Typical data-center weather: a little packet loss, the odd crash, a
    few slow racks."""
    return FaultSpec(link_rate=link_rate, crash_rate=crash_rate,
                     crash_rounds=crash_rounds,
                     straggler_rate=straggler_rate,
                     straggler_delay=straggler_delay, seed=seed, name="dcn")
