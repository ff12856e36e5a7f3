"""One request model end to end: ``Query`` in, ``QueryResult`` out.

Before this module, every serving layer reinvented the request surface:
``KeywordSearchEngine.query`` took five positional kwargs, ``QueryService``
and ``ClusterService`` took ``(keywords, semantics)`` pairs, and each layer
re-validated ``semantics``/``backend`` with its own copy of the same check.
``repro_torch.api`` centralizes that:

  * :class:`Query` — a frozen, normalized request (keywords tuple +
    semantics/index/backend); :meth:`Query.validate` is the single home of
    the checks the layers used to duplicate.
  * :class:`QueryResult` — ids + one :class:`~repro_torch.core.engine.QueryStats`
    -shaped stats dict + the serving generation vector, the same shape the
    HTTP gateway serializes.

Every layer (engine, service, cluster router, gateway) accepts a ``Query``
and returns a ``QueryResult``; the old string/kwargs signatures remain as
thin deprecated wrappers returning bare ndarrays, so existing callers stay
green.

    from repro_torch.api import Query
    q = Query.make("vinyl reissue", semantics="elca")
    res = engine.query(q)              # QueryResult
    res.ids, res.stats, res.generations
"""
from __future__ import annotations

from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field, replace
from typing import Callable

import numpy as np
import torch

SEMANTICS = ("slca", "elca")
INDEXES = ("tree", "dag")
# user-facing backend names: "scalar" runs the paper's host algorithms,
# "torch" the vectorized search in plain PyTorch, "fused" the hand-written
# CUDA kernel (membership + intersect + SLCA/ELCA in one launch), "chained"
# one hand-written CUDA kernel per phase (membership, then ELCA child sums).
BACKENDS = ("scalar", "torch", "fused", "chained")


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; CUDA must exist when asked for.

    Nothing moves to the CPU unless the caller names it: a CUDA device on a
    host without CUDA is an error, not a quiet fallback.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the host"
        )
    return dev


def validate_semantics(semantics: str) -> str:
    """The one semantics check (message kept stable for callers that match it)."""
    if semantics not in SEMANTICS:
        raise ValueError(f"semantics must be slca|elca, got {semantics!r}")
    return semantics


def validate_index(index: str) -> str:
    if index not in INDEXES:
        raise ValueError(f"index must be tree|dag, got {index!r}")
    return index


def validate_backend(backend: str | None) -> str | None:
    """``None`` means "whatever the serving layer is configured with"."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(
            f"backend must be one of {sorted(BACKENDS)}, got {backend!r}"
        )
    return backend


def normalize_keywords(keywords) -> tuple[str, ...]:
    """Whitespace-split strings, stringify everything else, freeze to tuple."""
    if isinstance(keywords, str):
        return tuple(keywords.split())
    return tuple(str(w) for w in keywords)


_QUERY_FIELDS = ("keywords", "semantics", "index", "backend", "traceparent")


@dataclass(frozen=True)
class Query:
    """A normalized keyword-search request.

    ``keywords`` is always a tuple of words (construct with a plain string
    or any iterable; ``__post_init__`` normalizes).  ``backend=None`` defers
    to the serving layer's configured drain backend.  Hashable, so it can
    key caches directly — the gateway's edge cache keys on
    :attr:`cache_key`, which deliberately excludes ``backend`` (all
    backends must return identical ids for the same logical query).
    """

    keywords: tuple[str, ...]
    semantics: str = "slca"
    index: str = "dag"
    backend: str | None = None
    # W3C-style trace header ("00-<32hex>-<16hex>-01"); None = untraced.
    # Deliberately lenient: a malformed value means "no spans", never an
    # error — tracing must not be able to fail a query.  Excluded from
    # cache_key (tracing never changes the answer).
    traceparent: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "keywords", normalize_keywords(self.keywords))

    @classmethod
    def make(cls, keywords, semantics: str = "slca", *, index: str = "dag",
             backend: str | None = None) -> Query:
        """Build and validate in one step."""
        return cls(keywords, semantics, index, backend).validate()

    def validate(self) -> Query:
        """Centralized semantics/index/backend checks; returns self."""
        validate_semantics(self.semantics)
        validate_index(self.index)
        validate_backend(self.backend)
        return self

    @property
    def cache_key(self) -> tuple:
        """Identity of the *logical* query: normalized keywords + semantics."""
        return (self.keywords, self.semantics, self.index)

    def with_trace(self, traceparent: str | None) -> Query:
        """A copy carrying ``traceparent`` (the gateway's propagation hook)."""
        return replace(self, traceparent=traceparent)

    def to_dict(self) -> dict:
        out = {
            "keywords": list(self.keywords),
            "semantics": self.semantics,
            "index": self.index,
            "backend": self.backend,
        }
        if self.traceparent is not None:
            out["traceparent"] = self.traceparent
        return out

    @classmethod
    def from_dict(cls, obj) -> Query:
        """Parse an untrusted JSON body (the gateway's 400 path on error)."""
        if not isinstance(obj, dict):
            raise ValueError("query body must be a JSON object")
        unknown = sorted(set(obj) - set(_QUERY_FIELDS))
        if unknown:
            raise ValueError(f"unknown query fields: {unknown}")
        if "keywords" not in obj:
            raise ValueError("query body needs a 'keywords' field")
        kws = obj["keywords"]
        if not isinstance(kws, (str, list, tuple)):
            raise ValueError("'keywords' must be a string or a list of strings")
        tp = obj.get("traceparent")
        return cls(
            keywords=kws,
            semantics=obj.get("semantics", "slca"),
            index=obj.get("index", "dag"),
            backend=obj.get("backend"),
            traceparent=tp if isinstance(tp, str) else None,
        ).validate()


@dataclass(frozen=True, eq=False)
class QueryResult:
    """Ids + stats + the generation vector that served them.

    ``stats`` follows the one :meth:`repro_torch.core.engine.QueryStats.to_dict`
    schema (plus per-request ``latency_ms`` where the layer measures it);
    ``generations`` is the cluster's per-shard generation vector at serve
    time (empty for single-process layers).  This is exactly the JSON shape
    the gateway emits.
    """

    ids: np.ndarray
    stats: dict = field(default_factory=dict)
    generations: tuple[int, ...] = ()

    def __len__(self) -> int:
        return int(len(self.ids))

    def to_dict(self) -> dict:
        return {
            "ids": [int(i) for i in self.ids],
            "stats": dict(self.stats),
            "generations": list(self.generations),
        }

    @classmethod
    def from_dict(cls, obj: dict) -> QueryResult:
        return cls(
            ids=np.asarray(obj.get("ids", []), dtype=np.int64),
            stats=dict(obj.get("stats", {})),
            generations=tuple(obj.get("generations", ())),
        )


def chain_future(inner: Future, finish: Callable) -> Future:
    """Return a Future resolving to ``finish(inner.result())``.

    The bridge the deprecated-signature layers use to wrap their existing
    ndarray futures into ``Future[QueryResult]`` without a waiter thread.
    Exceptions (and cancellation) propagate; ``finish`` runs on whichever
    thread completes ``inner``, so keep it cheap.
    """
    outer: Future = Future()

    def _done(f: Future) -> None:
        try:
            if f.cancelled():
                outer.cancel()
                return
            exc = f.exception()
            if exc is not None:
                outer.set_exception(exc)
            else:
                outer.set_result(finish(f.result()))
        except InvalidStateError:
            pass  # outer was cancelled by the caller; drop the result
        except Exception as e:  # finish() itself failed
            try:
                outer.set_exception(e)
            except InvalidStateError:
                pass

    inner.add_done_callback(_done)
    return outer
