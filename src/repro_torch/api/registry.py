"""Named registries for the pluggable round-pipeline stages.

Counterpart of `repro.api.registry`. Every stage of the paper's round —
mixing topology, privacy mechanism, local sparse-update rule, gradient
clipper, data stream, execution backend — is resolved by name through one of
these registries; a factory receives only the build kwargs it declares, and
an already-constructed instance passes through unchanged:

    >>> from repro_torch.api import MIXERS
    >>> MIXERS.build("ring", m=4).m
    4
    >>> mixer = MIXERS.build("ring", m=4)
    >>> MIXERS.build(mixer) is mixer
    True
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Generic, TypeVar

__all__ = ["Registry", "UnknownEntryError", "MIXERS", "MECHANISMS",
           "LOCAL_RULES", "CLIPPERS", "STREAMS", "BACKENDS"]

T = TypeVar("T")


class UnknownEntryError(KeyError, ValueError):
    """Unknown registry name (both a KeyError and a ValueError)."""

    def __str__(self) -> str:  # KeyError repr-quotes its arg; keep the message
        return self.args[0] if self.args else ""


class Registry(Generic[T]):
    """A name -> factory map with decorator registration.

    ``build`` accepts a registered name (the factory is called with the
    kwargs it declares) or an already-constructed instance (passed through).
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._factories: dict[str, Callable[..., T]] = {}

    def register(self, name: str, *aliases: str) -> Callable[[Callable[..., T]], Callable[..., T]]:
        def deco(factory: Callable[..., T]) -> Callable[..., T]:
            for key in (name, *aliases):
                if key in self._factories:
                    raise ValueError(f"{self.kind} {key!r} already registered")
                self._factories[key] = factory
            return factory
        return deco

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._factories))

    def describe(self) -> dict[str, str]:
        """name -> first docstring line of the factory, for listings."""
        out = {}
        for name in self.names():
            doc = inspect.getdoc(self._factories[name]) or ""
            out[name] = doc.splitlines()[0] if doc else ""
        return out

    def get(self, name: str) -> Callable[..., T]:
        try:
            return self._factories[name]
        except KeyError:
            raise UnknownEntryError(
                f"unknown {self.kind} {name!r}; registered: {self.names()}"
            ) from None

    def build(self, spec: str | T, options: dict | None = None,
              **injected: Any) -> T:
        """Build ``spec`` by name, or pass an instance through.

        ``injected`` kwargs are the caller's shared context (node count,
        privacy knobs, seed, device): a factory that does not declare one
        does not receive it. ``options`` are explicit user choices and must
        be declared by the factory — a typo'd option raises. ``options`` win
        over ``injected`` on collision.
        """
        if not isinstance(spec, str):
            return spec
        factory = self.get(spec)
        params = inspect.signature(factory).parameters
        has_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                         for p in params.values())
        options = dict(options or {})
        if not has_var_kw:
            injected = {k: v for k, v in injected.items() if k in params}
            unknown = sorted(k for k in options if k not in params)
            if unknown:
                accepted = sorted(k for k in params
                                  if k != "self" and not k.startswith("_"))
                raise TypeError(
                    f"{self.kind} {spec!r} got unexpected options {unknown}; "
                    f"accepted: {accepted}")
        return factory(**{**injected, **options})


# Build kwargs supplied by RunSpec.resolve_*():
#   MIXERS      — m (node count), seed, + user mixer_options
#   MECHANISMS  — eps, L (clip bound), noise_self, calibration,
#                 + user mechanism_options
#   LOCAL_RULES — prox_kind, + user local_rule_options
#   CLIPPERS    — max_norm, + user clipper_options
#   STREAMS     — n (feature dim), nodes, rounds (horizon), seed, device,
#                 + user stream_options
#   BACKENDS    — user backend_options (entries in repro_torch.api.backends)
MIXERS: Registry = Registry("mixer")
MECHANISMS: Registry = Registry("mechanism")
LOCAL_RULES: Registry = Registry("local rule")
CLIPPERS: Registry = Registry("clipper")
STREAMS: Registry = Registry("stream")
BACKENDS: Registry = Registry("backend")
