"""Real-model serving backend: registered functions are torch models.

Counterpart of ``repro/serving/backends.py``.  A function invocation is
(model, prompt, n_new_tokens); a *warm executor* is a worker-resident
model with its parameters on the device; a *cold start* is the real
parameter initialisation on the device plus a warm-up prefill and decode
step, measured, not modelled.  :class:`HermesFrontend` places each
invocation with any of the nine balancers of :mod:`repro_torch.policy`
at one replication: on the card, ``H`` launches the ``hermes_select``
kernel once per dispatch; the carried-state balancers (``HIKU``, ``DD``,
``SWARM``) keep their state on the device and learn from each
completion's measured wall time.

Everything runs on ``device`` (``None`` = CUDA).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.cluster import ClusterCfg
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.policy import resolve

#: the warm-up prompt of a cold start, as in the reference
WARMUP_TOKENS = 8


@dataclasses.dataclass
class Invocation:
    func: str
    prompt: np.ndarray           # [S] int
    n_new: int
    arrival: float = 0.0
    # filled by the platform:
    response_s: float | None = None
    cold: bool = False
    worker: int = -1
    tokens: np.ndarray | None = None
    prefill_s: float | None = None   # prompt prefill, synchronised
    decode_s: float | None = None    # all n_new decode steps, synchronised


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ModelRegistry:
    """Function store (the CouchDB analogue): name → model config.

    ``register(..., params=...)`` pins the parameters (for instance the
    reference's, from :func:`repro_torch.convert.params_from_reference`);
    otherwise each cold start initialises them on the device from
    ``seed``.
    """

    def __init__(self):
        self._fns: dict[str, tuple] = {}

    def register(self, name: str, cfg, seed: int = 0, params=None):
        self._fns[name] = (cfg, seed, params)

    def names(self):
        return list(self._fns)

    def build(self, name: str, device=None):
        cfg, seed, params = self._fns[name]
        model = build_model(cfg, device)
        if params is None:
            gen = torch.Generator(device=model.device).manual_seed(seed)
            params = model.init(gen)
        return model, params


class Executor:
    """A warm executor: a model and its resident params for one function."""

    def __init__(self, registry: ModelRegistry, name: str, max_len: int,
                 device=None):
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        self.model, self.params = registry.build(name, self.device)
        self.max_len = max_len
        # the cold start's warm-up: one prefill and one decode step
        cache = self.model.init_cache(1, max_len)
        toks = torch.zeros((1, WARMUP_TOKENS), dtype=torch.long,
                           device=self.device)
        _, cache = self.model.prefill(self.params, toks, cache)
        self.model.decode_step(
            self.params, toks[:, :1], cache,
            torch.full((1,), WARMUP_TOKENS, dtype=torch.int32,
                       device=self.device))
        _sync(self.device)
        self.cold_start_s = time.perf_counter() - t0

    def run(self, inv: Invocation) -> np.ndarray:
        """Greedy decode of ``inv.n_new`` tokens after the prompt; fills
        ``inv.prefill_s`` and ``inv.decode_s``.  The tokens stay on the
        device until the end (one read back, not one per step)."""
        model = self.model
        prompt = torch.as_tensor(np.asarray(inv.prompt), dtype=torch.long,
                                 device=self.device)[None]
        S = prompt.shape[1]
        if S + inv.n_new > self.max_len:
            raise ValueError(f"prompt of {S} + {inv.n_new} new tokens does "
                             f"not fit max_len={self.max_len}")
        cache = model.init_cache(1, self.max_len)
        t0 = time.perf_counter()
        logits, cache = model.prefill(self.params, prompt, cache)
        tok = logits[:, -1:].argmax(dim=-1)
        _sync(self.device)
        t1 = time.perf_counter()
        out = torch.empty(inv.n_new, dtype=torch.long, device=self.device)
        pos = torch.arange(S, S + inv.n_new, dtype=torch.int32,
                           device=self.device)
        for i in range(inv.n_new):
            out[i] = tok[0, 0]
            logits, cache = model.decode_step(self.params, tok, cache,
                                              pos[i:i + 1])
            tok = logits[:, -1:].argmax(dim=-1)
        tokens = out.cpu().numpy().astype(np.int32)
        inv.prefill_s, inv.decode_s = t1 - t0, time.perf_counter() - t1
        return tokens


class InProcessWorker:
    """One worker: warm-executor cache + invocation execution.

    The cache is bounded two ways, as in the reference: ``max_warm`` is the
    warm-pool budget (LRU eviction under pressure) and ``keepalive_s`` an
    optional idle timeout, applied lazily before each execution (``None``
    keeps executors forever).
    """

    def __init__(self, registry: ModelRegistry, max_len: int = 128,
                 max_warm: int = 4, keepalive_s: float | None = None,
                 device=None):
        self.registry = registry
        self.max_len = max_len
        self.max_warm = max_warm
        self.keepalive_s = keepalive_s
        self.device = resolve_device(device)
        self.warm: dict[str, Executor] = {}
        self.active = 0
        self.lru: list[str] = []
        self.idle_since: dict[str, float] = {}

    def has_warm(self, func: str) -> bool:
        return func in self.warm

    def expire_idle(self, now: float | None = None) -> int:
        """Release executors idle past the keep-alive window."""
        if self.keepalive_s is None:
            return 0
        now = time.perf_counter() if now is None else now
        dead = [f for f in self.warm
                if now - self.idle_since.get(f, now) > self.keepalive_s]
        for f in dead:
            del self.warm[f]
            self.idle_since.pop(f, None)
            if f in self.lru:
                self.lru.remove(f)
        return len(dead)

    def execute(self, inv: Invocation) -> Invocation:
        t0 = time.perf_counter()
        self.expire_idle(t0)
        if inv.func not in self.warm:
            if len(self.warm) >= self.max_warm:          # evict LRU
                victim = self.lru.pop(0)
                del self.warm[victim]
                self.idle_since.pop(victim, None)
            self.warm[inv.func] = Executor(self.registry, inv.func,
                                           self.max_len, self.device)
            inv.cold = True
        if inv.func in self.lru:
            self.lru.remove(inv.func)
        self.lru.append(inv.func)
        inv.tokens = self.warm[inv.func].run(inv)
        self.idle_since[inv.func] = time.perf_counter()
        inv.response_s = time.perf_counter() - t0
        return inv


class HermesFrontend:
    """Controller for in-process workers using a ported balancer.

    The balancer is the early-binding select of
    :func:`repro_torch.policy.resolve` on a cluster of ``n_workers`` ×
    ``cores`` with ``8 × cores`` slots, called at one replication with
    the reference's inputs (worker loads, warm column, function homes 0,
    uniform 0, the dispatch count as ``idx``).  ``H`` on the card
    launches ``hermes_select``.  A carried-state balancer (``HIKU``,
    ``DD``, ``SWARM``) has its state made by ``init_state`` on the
    device, threaded through every selection, and updated by
    ``on_complete`` after each invocation with its measured wall time
    (``perf_counter`` around ``execute``, a cold start included) and the
    worker's active count after the decrement, as in the reference.  An
    unknown balancer is a named ``ValueError``.
    """

    def __init__(self, registry: ModelRegistry, n_workers: int = 2,
                 cores: int = 2, max_len: int = 128, balancer: str = "H",
                 keepalive_s: float | None = None, device=None):
        self.device = resolve_device(device)
        self.workers = [InProcessWorker(registry, max_len,
                                        keepalive_s=keepalive_s,
                                        device=self.device)
                        for _ in range(n_workers)]
        self.cores = cores
        self.slots = 8 * cores
        self.fn_ids = {n: i for i, n in enumerate(registry.names())}
        cluster = ClusterCfg(n_workers=n_workers, cores=cores,
                             capacity_factor=8)
        res = resolve(f"E/{balancer}/PS", cluster, device=self.device)
        self._select, self._on_complete = res.select, res.on_complete
        self._lb_state = res.init_state(1, n_workers, len(self.fn_ids),
                                        self.device) \
            if res.stateful else None
        self._n_dispatched = 0

    def dispatch(self, inv: Invocation) -> Invocation:
        dev = self.device
        fid = self.fn_ids[inv.func]
        active = torch.tensor([[w.active for w in self.workers]],
                              dtype=torch.int32, device=dev)
        warm_col = torch.tensor([[int(w.has_warm(inv.func))
                                  for w in self.workers]],
                                dtype=torch.int32, device=dev)
        func = torch.tensor([fid], dtype=torch.int64, device=dev)
        args = (active, warm_col, func,
                torch.zeros((1, len(self.fn_ids)), dtype=torch.int32,
                            device=dev),
                torch.zeros(1, dtype=torch.float64, device=dev),
                self._n_dispatched)
        if self._lb_state is not None:
            w, self._lb_state = self._select(self._lb_state, *args)
        else:
            w = self._select(*args)
        w = int(w[0])
        self._n_dispatched += 1
        if w < 0:
            raise RuntimeError("cluster full")
        inv.worker = w
        worker = self.workers[w]
        worker.active += 1
        t0 = time.perf_counter()
        try:
            return worker.execute(inv)
        finally:
            worker.active -= 1
            if self._lb_state is not None:
                self._lb_state = self._on_complete(
                    self._lb_state,
                    torch.tensor([w], dtype=torch.int64, device=dev), func,
                    torch.tensor([time.perf_counter() - t0],
                                 dtype=torch.float64, device=dev),
                    torch.tensor([worker.active], dtype=torch.int64,
                                 device=dev))
