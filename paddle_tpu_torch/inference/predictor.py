"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``paddle_tpu/inference/predictor.py``'s
``ContinuousBatchingEngine`` on one device: no mesh yet (ROADMAP.md,
queue A). ``weight_bits``
quantizes the weights once at construction (int8 per channel or int4
per group, ``generate.quantize_weights``), and every forward
dequantizes them at each use. Each :meth:`step` admits queued requests
FIFO into free slots (prefix-cache sharing and copy-on-write included),
advances one pending admission by one prefill chunk, then advances
every fully prefilled slot by one decode token — or, with speculation
on, by a verified run of drafted tokens:

- ``spec_k``: n-gram drafts (:mod:`..serving.speculative`), all rows
  verified in one batched forward, each committing its longest accepted
  prefix plus the bonus token;
- ``draft_layers``: a truncated-layer draft model over the target's own
  weights with a second paged pool proposes the drafts (lazy admission,
  catch-up chunks, ``spec_k`` draft decode steps);
- ``spec_tree=(width, depth)``: the draft model's top-``width``
  candidates per depth form a comb token tree, verified in ONE forward
  under its ancestor mask (kernel B11-tree when ``fused``); the longest
  accepted root path commits.

Greedy speculation is token-identical to plain greedy decode.

``constraints=True`` serves grammar-constrained requests
(:mod:`..serving.constraints`): a request carries a token-level DFA
(``constraint=``), the engine keeps one ``(max_batch, vocab)``
allowed-token mask on the host, each row rebuilt from its request's DFA
state whenever the state moves, and applies the device copy to the
logits before sampling, in every decode step and in the first token of
a fresh admission's prefill. The state advances at commit with the
token that landed; a preempted request keeps its state on the handle
and its row is rebuilt when it is seated again. Speculation is refused
with constraints (a verify commits tokens no mask saw), as the JAX
engine refuses it.

The SLO control plane (:class:`~..serving.scheduler.ServingScheduler`)
composes the same lifecycle pieces — :meth:`admit_request`,
:meth:`preempt_request` (pages back to the pool, token-identical resume
through the continuation prefill), :meth:`cancel_request`,
:meth:`prefill_step`, :meth:`decode_step` — under priority classes,
deadlines and a per-step token budget. Every forward is split into a
DISPATCH half (launch, leave the result on the card) and a COMMIT half
(the one device-to-host fetch and all host bookkeeping); ``overlap=True``
marks the engine for the scheduler's double-buffered pipeline, which
plans step N+1 while step N runs. Dispatch never waits on the card: its
host inputs go up through pinned host memory with non-blocking copies
on the one CUDA stream (:meth:`ContinuousBatchingEngine._up`).

``host_tier=True`` puts the host tier of :mod:`..serving.host_tier`
under the pool: a preempted decode-phase request's pages SWAP OUT to
host memory (non-blocking on an ``overlap`` engine, fenced at the next
commit) and come back by one scatter when it is admitted again, with
the replay prefill as the fallback when the payload was dropped, went
stale or fails its checksum; prefix chains evicted under pool pressure
demote to the host and promote back; registered prompts write through
to a standing store (``host_tier_kw``: ``host_capacity_pages``,
``prefix_store_dir``, ``persist_prefix``, ``store``,
``swap_in_retries``). :meth:`ContinuousBatchingEngine.export_prefilled`
/ :meth:`~ContinuousBatchingEngine.import_prefilled` /
:meth:`~ContinuousBatchingEngine.finish_handoff` hand a prefilled
request from one engine to another, through host memory or, with
``src_engine``, page to page on the device.

``adapters=`` serves many LoRA variants of the base weights in one batch
(:mod:`..serving.adapters`): a request's ``adapter_id`` pins a slot of
the engine's :class:`~..serving.adapters.AdapterPool` at admission (a
pin before any page work, dropped on a failed admission, at preemption,
retirement and after a handoff), the engine mirrors each row's slot
into a ``(max_batch,)`` array, uploaded with the other step inputs, and
every prefill chunk, decode step and verify adds the rows' q/o LoRA
term; the draft model's forwards take none. Slot 0 is the base model,
an exact zero.

Observability and faults: every lifecycle edge and commit feeds the
hooks of :mod:`~paddle_tpu_torch.observability.hooks` (admissions,
prefix hits, preemptions, resumes, retirements, per-step occupancy,
speculation and grammar counters, request traces), and the fault points
of :mod:`~paddle_tpu_torch.serving.resilience` sit where the JAX
engine has them, in the same order relative to launch and commit:
``prefill_chunk``, ``decode_step``, ``verify_step``, ``tree_verify``
and ``draft_propose`` before their forwards launch, ``dispatch`` after
a decode or verify launch, ``commit`` and ``transfer`` at the top of
its commit half, before the fetch, ``swap_out`` and ``swap_in`` in the
host tier before their page moves. A fault at any of them commits
nothing, so an :class:`~..serving.resilience.EngineSupervisor` recovers
by replaying its journal. A timing hook waits for the card only in a
commit half.

Greedy decoding is token-identical to the JAX engine's on the same
parameters; temperature sampling draws from a ``torch.Generator`` (the
JAX engine's ``jax.random`` key), so sampled tokens differ from JAX's.
Sampled speculation accepts with ``numpy.random.default_rng`` seeded
from the generator's ``initial_seed()``. The chunk widths (page-rounded)
and gathered-context widths (power-of-two page buckets) are the JAX
engine's, so the attention reductions run over the same widths.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import generate as _gen
from ..observability import hooks as _obs
from ..serving.resilience import fault_point as _fault_point
from ..serving.constraints import ConstraintState, TokenDFA
from ..serving.adapters import AdapterPool
from ..serving.host_tier import TieredKVCache
from ..serving.paged_cache import PagedKVCache, PoolExhausted
from ..serving.speculative import (Speculator, TreeDraft, build_comb_tree,
                                   longest_accepted_path,
                                   longest_accepted_prefix,
                                   rejection_sample_tokens,
                                   tree_ancestor_matrix, tree_depths,
                                   tree_rejection_sample)

#: the kinds of forward the engine counts in ``stats()["forwards"]``
FORWARDS = ("prefill", "decode", "verify", "tree", "draft_catchup",
            "draft_decode")


class GenerationRequest:
    """One in-flight generation request tracked by the engine.

    ``finish_reason`` holds the string values of
    :class:`~..serving.policy.FinishReason`: ``eos`` / ``max_len`` on
    completion, ``deadline_exceeded`` (or a caller's reason) when
    cancelled, and the transient ``preempted`` while the request sits
    evicted awaiting resume (``done`` stays False and the reason clears
    when its replay prefill completes).

    ``priority`` (lower = more important), ``deadline_at`` /
    ``submitted_at`` / ``enqueued_at`` (scheduler-clock seconds; the
    last resets on every requeue) and ``preemptions`` are
    scheduler-facing metadata; the engine's own FIFO path ignores them.

    ``swapped``: its KV is in the host tier (a swap-out payload exists
    for its rid) while it waits to resume. ``adapter_id``: the LoRA
    variant serving it (0 = the base model). ``constraint``: the
    request's live :class:`~..serving.constraints.ConstraintState`
    (None = free); it rides the handle through preemption and resume.
    ``trace``: its
    :class:`~..observability.tracing.RequestTrace` while request tracing
    is on.
    """
    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "tokens", "done", "finish_reason", "slot", "priority",
                 "deadline_at", "submitted_at", "enqueued_at",
                 "preemptions", "swapped", "adapter_id", "constraint",
                 "trace")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.tokens: List[int] = []      # generated tokens (no prompt)
        self.done = False
        self.finish_reason: Optional[str] = None
        self.slot: Optional[int] = None
        self.priority = 1                # serving.policy.Priority.NORMAL
        self.deadline_at: Optional[float] = None
        self.submitted_at: Optional[float] = None
        self.enqueued_at: Optional[float] = None   # latest (re)queue time
        self.preemptions = 0
        self.swapped = False    # KV currently host-resident
        self.adapter_id = 0     # 0 = the base model
        self.constraint = None
        self.trace = None

    def resume_sequence(self) -> np.ndarray:
        """The tokens whose KV must be in the pool before this request
        can (re)enter decode: the prompt plus — after a preemption —
        every generated token EXCEPT the last (decode feeds the last
        sampled token back through the decode step, which writes its KV
        then)."""
        if not self.tokens:
            return self.prompt[0]
        return np.concatenate(
            [self.prompt[0], np.asarray(self.tokens[:-1], np.int32)])

    @property
    def output(self) -> np.ndarray:
        """prompt + generated tokens, one row."""
        return np.concatenate(
            [self.prompt[0], np.asarray(self.tokens, np.int32)])


class InFlightStep:
    """One dispatched decode or verify forward awaiting its commit: the
    kind (``"decode"``, ``"spec"`` or ``"tree"``), the mask it ran, a
    SNAPSHOT of the per-slot request ids and seat generations at
    dispatch, its device output (sampled tokens, greedy targets or f32
    logits) and what the commit needs besides. The commit credits a
    slot only while it still holds the same seating of the same
    request: a slot preempted and re-admitted between dispatch and
    commit (even by the same request) gets nothing, and the victim
    re-decodes the dropped token on resume. ``t0`` / ``t0f`` / ``ttr``
    are the observability anchors taken at dispatch (0 when off) and
    ``raw`` a constrained decode's unmasked argmax."""
    __slots__ = ("kind", "mask", "rids", "seats", "out", "drafts", "dlen",
                 "qs", "rows", "t0", "t0f", "ttr", "raw")

    def __init__(self, kind, mask, rids, seats, out, drafts=None,
                 dlen=None, qs=None, rows=None, t0=0, t0f=0, ttr=0,
                 raw=None):
        self.kind = kind
        self.mask = mask
        self.rids = rids                # per-slot rid snapshot
        self.seats = seats              # per-slot seating generation
        self.out = out
        self.drafts = drafts            # slot -> drafts / TreeDraft
        self.dlen = dlen                # (B,) linear draft counts
        self.qs = qs                    # slot -> (j, V) draft-model q
        self.rows = rows                # tree verify's un-placed KV rows
        self.t0 = t0
        self.t0f = t0f
        self.ttr = ttr
        self.raw = raw


def _not_ported(what: str, where: str):
    raise NotImplementedError(
        f"ContinuousBatchingEngine: {what} is not ported yet — see "
        f"ROADMAP.md, queue A step {where}")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ContinuousBatchingEngine:
    """Continuous-batching decode over a paged KV cache.

    ``max_batch`` slots run one decode step together; new prompts are
    admitted into free slots mid-decode and finished rows retire at
    once, their pages recycled. Prefill is chunked (``prefill_chunk``
    tokens, page-rounded; default one chunk per prompt) and prefix-
    cached (a trie maps previously prefilled prompt pages into the new
    request's block table). A request is admitted only when the pool
    can cover ``prompt + max_new_tokens``; otherwise it waits
    (back-pressure) until running requests retire.

    ``kv_cache_dtype``: None (model dtype) or ``"int8"`` (per-row
    scales). ``fused``: decode attention through the fused RoPE kernel
    (B10) and prefill and verify attention through the flash chunk
    kernel (B11, B11-tree) instead of B9 and the plain chunk
    composition. ``device`` defaults to the card; ``device="cpu"`` runs
    every kernel's plain version.

    Speculation (module docstring): ``spec_k`` drafts per row and step
    (0 = off), ``spec_ngram`` the n-gram proposer's longest n,
    ``speculator`` a ready :class:`~..serving.speculative.Speculator`,
    ``draft_layers`` the draft model's depth, ``draft_pages`` its pool's
    page count (default: every slot at full length), ``spec_tree``
    ``(width, depth)`` of the comb tree (needs ``draft_layers``; its
    depth is ``spec_k``, at most 32 nodes).

    ``weight_bits``: None (weights as given), 8 (int8 per output
    channel) or 4 (int4 per group of 128 input rows, held in int8):
    ``generate.quantize_weights`` at construction; the draft model
    shares the quantized stacks.

    ``enable_prefix_cache``: False builds the cache without its prefix
    trie. ``overlap``: a :class:`~..serving.scheduler.ServingScheduler`
    attached without its own ``overlap=`` inherits it and runs the
    double-buffered pipeline; the engine's own :meth:`step` stays
    synchronous (each dispatch followed by its commit), the reference
    the pipeline is held to.

    ``constraints``: accept grammar-constrained requests (module
    docstring); the mask costs ``max_batch * vocab`` bools on the host
    and on the device, so only a constrained engine holds it.

    ``host_tier``: build the cache as a
    :class:`~..serving.host_tier.TieredKVCache` (module docstring), with
    ``host_tier_kw`` passed to it.

    ``adapters``: an :class:`~..serving.adapters.AdapterPool` on the
    engine's device, or a dict of its keyword arguments (``slots``,
    ``rank``, ``registry``, ``store``), built on the engine's device;
    None leaves the LoRA term out of every forward (module docstring).
    """

    def __init__(self, params, cfg, *, max_batch: int = 4,
                 page_size: int = 16, max_len: Optional[int] = None,
                 num_pages: Optional[int] = None, kv_cache_dtype=None,
                 temperature: float = 0.0, eos_token_id=None,
                 generator: Optional[torch.Generator] = None,
                 prefill_chunk: Optional[int] = None,
                 enable_prefix_cache: bool = True, fused: bool = False,
                 spec_k: int = 0, spec_ngram: int = 3, speculator=None,
                 draft_layers: Optional[int] = None,
                 draft_pages: Optional[int] = None,
                 spec_tree: Optional[Tuple[int, int]] = None,
                 weight_bits: Optional[int] = None, overlap: bool = False,
                 mesh=None, adapters=None, constraints: bool = False,
                 host_tier: bool = False,
                 host_tier_kw: Optional[Dict] = None,
                 device: DeviceLike = None):
        if mesh is not None:
            _not_ported("mesh (tp / tp x dp serving)", "1.9")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.weight_bits = weight_bits
        if weight_bits is not None:
            self.params = _gen.quantize_weights(self.params, cfg,
                                                bits=weight_bits)
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        self.fused = bool(fused)
        self.overlap = bool(overlap)
        cache_kw = dict(page_size=page_size, num_pages=num_pages,
                        kv_dtype=kv_cache_dtype,
                        enable_prefix_cache=enable_prefix_cache,
                        device=self.device)
        if host_tier:
            self.cache = TieredKVCache(
                cfg, max_batch, max_len or cfg.max_seq_len,
                **cache_kw, **(host_tier_kw or {}))
        else:
            self.cache = PagedKVCache(
                cfg, max_batch, max_len or cfg.max_seq_len, **cache_kw)
        if prefill_chunk is not None:
            # page-rounded, so chunk boundaries stay page-aligned
            prefill_chunk = self.cache.pages_for(
                max(1, int(prefill_chunk))) * self.cache.page_size
        self.prefill_chunk = prefill_chunk
        self.max_batch = max_batch
        if isinstance(adapters, dict):
            adapters = AdapterPool(cfg, device=self.device, **adapters)
        if adapters is not None and adapters.device != self.device:
            raise ValueError(
                f"ContinuousBatchingEngine: the AdapterPool lives on "
                f"{adapters.device}, the engine on {self.device} — build "
                f"the pool on the engine's device")
        self.adapters = adapters
        # each row's pool slot, set at seating (the pin keeps it valid)
        self._aslot = np.zeros((max_batch,), np.int32)
        #: replica index carried by trace spans (-1 = standalone; a
        #: supervisor stamps it)
        self.replica_id = -1
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.generator = generator
        self._queue: List[GenerationRequest] = []
        self._slots: List[Optional[GenerationRequest]] = [None] * max_batch
        self._last = np.zeros((max_batch,), np.int32)
        # per-slot seating that the commit guard compares with its
        # dispatch snapshot: _install_slot and _clear_slot are the only
        # writers of _rids (-1 = empty) and _seat (bumped on every
        # seating)
        self._rids = np.full((max_batch,), -1, np.int64)
        self._seat = np.zeros((max_batch,), np.int64)
        # slot -> [request, sequence being prefilled (prompt, or the
        # preemption-resume replay), tokens already in pages]
        self._pending: Dict[int, list] = {}
        self._next_rid = 0
        self._steps = 0
        self.forwards = dict.fromkeys(FORWARDS, 0)
        # dispatched, uncommitted work: at most one decode/verify
        # forward plus this step's prefill chunks
        self._inflight: Optional[InFlightStep] = None
        self._inflight_chunks: List[Dict] = []
        self._fence_ns = 0
        # grammar constraints: the host mask (one row per slot, all True
        # for a free or empty slot) and its device copy, uploaded again
        # only after a host-side change (the dirty flag)
        self.constraints = bool(constraints)
        self._cmask = (np.ones((max_batch, cfg.vocab_size), bool)
                       if self.constraints else None)
        self._cmask_dev: Optional[torch.Tensor] = None
        self._cmask_dirty = True
        #: uploads of the mask so far (one per dispatch that found it
        #: changed)
        self.cmask_uploads = 0
        self._init_spec(spec_k, spec_ngram, speculator, draft_layers,
                        draft_pages, spec_tree, max_len or cfg.max_seq_len,
                        page_size, kv_cache_dtype)

    def _init_spec(self, spec_k, spec_ngram, speculator, draft_layers,
                   draft_pages, spec_tree, max_len, page_size, kv):
        """Validate the speculation arguments (the JAX engine's rules and
        errors) and build the speculator, the draft model over the
        target's own weights and its second paged pool."""
        if spec_tree is not None:
            w, d = int(spec_tree[0]), int(spec_tree[1])
            if draft_layers is None:
                raise ValueError(
                    "spec_tree requires draft_layers: the tree's "
                    "candidates come from the draft model's per-step "
                    "top-width distributions")
            if w < 1 or d < 1:
                raise ValueError(
                    f"spec_tree=(width, depth) must both be >= 1, got "
                    f"{spec_tree}")
            if spec_k and int(spec_k) != d:
                raise ValueError(
                    f"spec_tree depth {d} conflicts with spec_k="
                    f"{spec_k}: the tree's chain IS the linear draft "
                    f"(leave spec_k at 0 or pass spec_k={d})")
            spec_k = d
            if 1 + w * d > 32:
                raise ValueError(
                    f"spec_tree=({w}, {d}) needs {1 + w * d} tree "
                    f"nodes; the fused kernel's per-query ancestor "
                    f"bitmask holds at most 32")
            self.spec_tree: Optional[Tuple[int, int]] = (w, d)
            self._tree_T: Optional[int] = 1 + w * d
        else:
            self.spec_tree = None
            self._tree_T = None
        if draft_layers is not None and int(spec_k) < 1:
            raise ValueError(
                "draft_layers requires spec_k >= 1: the draft model "
                "proposes spec_k tokens per step")
        self.spec_k = int(spec_k)
        if self.spec_k and self.constraints:
            raise ValueError(
                "spec_k > 0 cannot combine with constraints=True: "
                "a verify batch commits tokens the per-row grammar "
                "mask never saw — run constrained requests on a "
                "plain-decode engine (the scenarios compose at the "
                "cluster tier, one engine per workload class)")
        self.spec = None
        if self.spec_k:
            self.spec = (speculator if speculator is not None
                         else Speculator(self.spec_k, ngram_max=spec_ngram))
        # host-side acceptance RNG of sampled speculation, seeded from
        # the engine's generator: two engines built alike draw alike
        self._accept_rng = np.random.default_rng(
            int(self.generator.initial_seed()) & 0x7FFFFFFF)
        self.draft_layers = (int(draft_layers)
                             if draft_layers is not None else None)
        self.draft_params = self.draft_cfg = self.draft_cache = None
        if self.draft_layers is not None:
            self.draft_params, self.draft_cfg = _gen.make_draft_params(
                self.params, self.cfg, self.draft_layers)
            # + spec_k + 1 past max_len: the draft loop feeds up to
            # spec_k positions beyond the committed context
            self.draft_cache = PagedKVCache(
                self.draft_cfg, self.max_batch, max_len + self.spec_k + 1,
                page_size=page_size, num_pages=draft_pages, kv_dtype=kv,
                device=self.device)
        # per-slot draft bookkeeping: _draft_base[slot] is the main
        # context length at the last propose (the draft pool's valid
        # prefix is base + the accepted tokens that MATCH the fed chain);
        # _draft_chain holds the chain tokens fed through the draft
        # model, _draft_q the q distributions of sampled linear drafts
        self._draft_base = np.zeros((self.max_batch,), np.int64)
        self._draft_chain: Dict[int, np.ndarray] = {}
        self._draft_q: Dict[int, np.ndarray] = {}

    # ---- request intake ----
    def create_request(self, prompt, max_new_tokens: int = 16,
                       eos_token_id=None, adapter_id: int = 0,
                       constraint=None) -> GenerationRequest:
        """Validate and build a request without queueing it.

        ``adapter_id``: the LoRA variant serving the request (0 = the
        base model); needs an engine with an adapter pool, which must be
        able to resolve it (``AdapterPool.validate_id``: an id that
        cannot load is refused here, not at admission inside the serving
        loop). Its slot is pinned at admission, not here.
        ``constraint``: a :class:`~..serving.constraints.TokenDFA`
        (wrapped in a fresh :class:`~..serving.constraints.
        ConstraintState` with the request's eos) or a live
        ``ConstraintState``; needs ``constraints=True``."""
        if int(adapter_id) != 0:
            if self.adapters is None:
                raise ValueError(
                    f"create_request: adapter_id={adapter_id} on an "
                    f"engine without an adapter pool — pass adapters= "
                    f"at construction")
            self.adapters.validate_id(adapter_id)
        if constraint is not None and not self.constraints:
            raise ValueError(
                "create_request: a grammar constraint needs an engine "
                "built with constraints=True (the sampling step applies "
                "the per-row mask only there)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("submit: empty prompt")
        need = self.cache.pages_for(prompt.size + int(max_new_tokens))
        if need > self.cache.pages_per_seq:
            raise ValueError(
                f"request of {prompt.size}+{max_new_tokens} tokens "
                f"exceeds max_len={self.cache.max_len}")
        usable = self.cache.allocator.num_usable
        if need > usable:
            raise ValueError(
                f"request needs {need} pages but the pool holds only "
                f"{usable}; grow num_pages or shrink the request")
        req = GenerationRequest(
            self._next_rid, prompt, max_new_tokens,
            self.eos_token_id if eos_token_id is None else eos_token_id)
        req.adapter_id = int(adapter_id)
        if isinstance(constraint, TokenDFA):
            constraint = ConstraintState(constraint,
                                         eos_token_id=req.eos_token_id)
        req.constraint = constraint
        self._next_rid += 1
        return req

    def attach_constraint(self, req: GenerationRequest,
                          constraint) -> GenerationRequest:
        """Attach a live :class:`~..serving.constraints.ConstraintState`
        to an existing request handle (a restored session's grammar
        state, rebuilt outside :meth:`create_request`). An engine built
        without ``constraints=True`` refuses: it would decode the
        session unconstrained."""
        if constraint is None:
            return req
        if not self.constraints:
            raise ValueError(
                "attach_constraint: this engine was built without "
                "constraints=True — a grammar-constrained session in it "
                "would decode unconstrained; rebuild the engine with "
                "constraints=True")
        req.constraint = constraint
        return req

    def submit(self, prompt, max_new_tokens: int = 16,
               eos_token_id=None, adapter_id: int = 0,
               constraint=None) -> GenerationRequest:
        """Queue a prompt (1-D int sequence); returns the request handle
        (``.done`` / ``.tokens`` / ``.output`` fill in as steps run).
        ``adapter_id`` and ``constraint`` as in :meth:`create_request`."""
        req = self.create_request(prompt, max_new_tokens=max_new_tokens,
                                  eos_token_id=eos_token_id,
                                  adapter_id=adapter_id,
                                  constraint=constraint)
        self._queue.append(req)
        return req

    # ---- slots ----
    def _install_slot(self, slot: int, req: GenerationRequest):
        """Seat ``req`` in ``slot`` and mirror what the commit guard
        reads (rid and seating generation), the row's adapter slot (the
        pin taken at admission keeps it valid while seated) and, with
        constraints, the slot's mask row from the DFA state the request
        has reached (all True for a free request)."""
        req.slot = slot
        self._slots[slot] = req
        self._rids[slot] = req.rid
        self._seat[slot] += 1
        self._aslot[slot] = (self.adapters.slot_of(req.adapter_id)
                             if self.adapters is not None else 0)
        if self.constraints:
            self._mask_row(slot, req)

    def _clear_slot(self, slot: int):
        self._slots[slot] = None
        self._rids[slot] = -1
        self._aslot[slot] = 0
        if self.draft_cache is not None:
            # the draft pool's state is disposable: retire, preempt,
            # swap and cancel just drop the slot's draft pages (a new
            # tenant or a resume catches up cold)
            if self.draft_cache.active[slot]:
                self.draft_cache.release(slot)
            self._draft_chain.pop(slot, None)
            self._draft_q.pop(slot, None)
            self._draft_base[slot] = 0
        if self.constraints:
            self._mask_row(slot, None)

    def _mask_row(self, slot: int, req: Optional[GenerationRequest]):
        """Rebuild ``slot``'s row of the host mask from ``req``'s DFA
        state (``ConstraintState.mask``, which counts), all True for a
        free request or an empty slot, and mark the mask for upload."""
        self._cmask[slot] = (req.constraint.mask(self.cfg.vocab_size)
                             if req is not None and req.constraint is not None
                             else True)
        self._cmask_dirty = True

    def admit_request(self, req: GenerationRequest) -> bool:
        """Place ``req`` into a free slot, reserving its pages (prefix-
        shared where the trie holds them). False when every slot is
        busy; raises :class:`PoolExhausted` when the pool can't cover
        it. The sequence then prefills chunk by chunk in
        :meth:`prefill_step`. A preempted request re-enters the same
        way: its :meth:`~GenerationRequest.resume_sequence` (prompt plus
        every generated token but the last) replays through the
        continuation prefill, and decode goes on from its last token.
        Under the host tier a request that was SWAPPED OUT comes back by
        one scatter of its pages instead, decode-ready at once; a
        payload that was dropped, went stale or fails its checksum falls
        back to the replay.

        With an adapter pool the request's adapter is pinned FIRST
        (``AdapterPool.acquire``, which may load, promote or raise
        :class:`~..serving.adapters.AdapterPoolExhausted`, a
        :class:`PoolExhausted`: back-pressure), and any failure after it
        drops the pin again, so a deferred admission leaks nothing."""
        free = self.cache.free_slots()
        if not free:
            return False
        with self._adapter_pinned(req):
            return self._admit_pinned(req, free[0])

    @contextlib.contextmanager
    def _adapter_pinned(self, req: GenerationRequest):
        """Pin ``req``'s adapter (none for the base model) around a
        seating; a seating that raises drops the pin again."""
        if self.adapters is not None and req.adapter_id:
            self.adapters.acquire(req.adapter_id)
        try:
            yield
        except BaseException:
            self._release_adapter(req)
            raise

    def _release_adapter(self, req: GenerationRequest):
        """Drop ``req``'s adapter pin (a failed seating, preemption,
        retirement, the exporting side of a handoff)."""
        if self.adapters is not None and req.adapter_id:
            self.adapters.release(req.adapter_id)

    def _admit_pinned(self, req: GenerationRequest, slot: int) -> bool:
        """The page side of :meth:`admit_request`, run with the
        request's adapter pin (if any) held."""
        cache = self.cache
        seq = req.resume_sequence()
        # trace: queue_wait closes at the admission instant, so the
        # swap-in below lands in its own span
        t_adm = _obs.serving_trace_now()
        if (req.swapped and req.tokens
                and getattr(cache, "host", None) is not None):
            # a raised swap_in (injected fault, PoolExhausted) leaves the
            # flag set: the payload committed nothing and survives for
            # the admission retried after recovery or back-pressure
            length = cache.swap_in(
                slot, req.rid, req.prompt.shape[1] + req.max_new_tokens,
                expect_tokens=seq.size)
            req.swapped = False
            if length is not None:
                self._install_slot(slot, req)
                # decode goes on from the last sampled token, as after
                # the replay's final chunk
                self._last[slot] = np.int32(req.tokens[-1])
                req.finish_reason = None    # clears transient "preempted"
                _obs.serving_resumed(1, 0)  # no replayed tokens
                _obs.serving_trace_admitted(
                    req, replica=self.replica_id, slot=slot, t_ns=t_adm)
                _obs.serving_trace_span(
                    req, "swap_in", t_adm, replica=self.replica_id,
                    slot=slot, seq=len(req.tokens),
                    meta={"tokens": int(length)})
                return True
            # payload gone (swap_in counted the fallback): replay below
            if t_adm:
                _obs.serving_trace_mark(
                    req, "swap_fallback", replica=self.replica_id,
                    slot=slot, meta={"why": getattr(
                        cache, "last_swap_fallback", None)})
        _, shared = self.cache.admit_prompt(
            slot, seq, req.prompt.shape[1] + req.max_new_tokens)
        self._install_slot(slot, req)
        self._pending[slot] = [req, seq, int(shared)]
        _obs.serving_trace_admitted(
            req, replica=self.replica_id, slot=slot, t_ns=t_adm,
            meta={"shared": int(shared)} if t_adm else None)
        if req.preemptions > 0:
            if t_adm:
                _obs.serving_trace_mark(
                    req, "resume_replay", replica=self.replica_id,
                    slot=slot,
                    meta={"replay": int(seq.size) - int(shared)})
            # a resume has its own counters: counted as an admission it
            # would break admissions - evictions == 0 after a drain, and
            # its generated-token replay is not a prompt prefix miss
            _obs.serving_resumed(1, seq.size - int(shared))
        else:
            _obs.serving_admitted(1, seq.size)
            _obs.serving_prefix(int(shared), seq.size - int(shared))
        return True

    def swap_candidate(self, req: GenerationRequest) -> bool:
        """True when preempting ``req`` would SWAP its KV to the host
        tier rather than evict it for a replay: the cache is tiered and
        the request is past its prefill (it has committed KV). The
        :class:`~..serving.policy.PreemptionPolicy` prefers such victims
        when the scheduler passes this predicate."""
        return (getattr(self.cache, "host", None) is not None
                and req.slot is not None
                and req.slot not in self._pending
                and int(self.cache.lengths[req.slot]) > 0)

    def preempt_request(self, req: GenerationRequest) -> int:
        """Evict a RUNNING request's pages back to the pool
        (:meth:`PagedKVCache.evict_for_preempt`: pages the prefix trie
        or another table shares survive under those references) and
        reset it for a token-identical resume through
        :meth:`admit_request`. Under the host tier a decode-phase
        victim's live pages SWAP OUT first (:meth:`swap_candidate`;
        non-blocking on an ``overlap`` engine), so that its resume is
        a scatter. ``finish_reason`` reads the transient
        ``"preempted"`` until the resume completes; ``done`` stays
        False. Returns the number of pages returned to the free list. A
        decode step in flight for the slot is dropped at its commit
        (the seat guard)."""
        slot = req.slot
        if slot is None or self._slots[slot] is not req:
            raise ValueError(
                f"preempt_request: request {req.rid} is not running")
        swap = self.swap_candidate(req)
        self._pending.pop(slot, None)
        t_tr = _obs.serving_trace_now()
        if swap:
            freed = self.cache.swap_out(slot, req.rid,
                                        nonblocking=self.overlap)
            req.swapped = True
            if t_tr:
                _obs.serving_trace_span(
                    req, "swap_out", t_tr, replica=self.replica_id,
                    slot=slot, seq=len(req.tokens),
                    meta={"pages": int(freed),
                          "nonblocking": bool(self.overlap)})
        else:
            freed = self.cache.evict_for_preempt(slot)
        if t_tr:
            _obs.serving_trace_mark(
                req, "preempt", replica=self.replica_id, slot=slot,
                seq=len(req.tokens), meta={"swap": bool(swap)})
        self._clear_slot(slot)
        req.slot = None
        req.preemptions += 1
        req.finish_reason = "preempted"
        # a preempted request holds no device residency: its resume pins
        # the adapter again (promoting it if the slot was reclaimed)
        self._release_adapter(req)
        _obs.serving_preempted(1, freed)
        return freed

    def cancel_request(self, req: GenerationRequest,
                       reason: str = "cancelled"):
        """Finish ``req`` without further decode (for example a
        scheduler's ``deadline_exceeded``): a running request releases
        its slot and pages, a queued or preempted one is just marked
        done. Idempotent on finished requests."""
        if req.done:
            return
        if req.slot is not None and self._slots[req.slot] is req:
            self._pending.pop(req.slot, None)
            self._retire(req, reason)
            return
        try:
            self._queue.remove(req)
        except ValueError:
            pass                        # a scheduler-owned queue entry
        req.done = True
        req.finish_reason = reason
        _obs.serving_trace_finish(req, reason, replica=self.replica_id)
        if getattr(self.cache, "host", None) is not None:
            # a victim cancelled while swapped out retires its payload
            # with it (nothing will ever swap it in)
            self.cache.drop_swapped(req.rid)
        if req.preemptions > 0:
            # preempted awaiting resume: it WAS admitted, so the cancel
            # finalizes its retirement (admissions - evictions drains
            # to zero)
            _obs.serving_retired(1, reason)
        else:
            # never held a slot: a cancellation, not an eviction
            _obs.serving_cancelled(1, reason)

    def _admit(self):
        """Fill free slots from the queue, FIFO: a head-of-line request
        the pool can't cover yet blocks admission. Priority-aware
        admission lives in :class:`~..serving.scheduler.
        ServingScheduler`, which calls :meth:`admit_request` directly."""
        while self._queue:
            try:
                if not self.admit_request(self._queue[0]):
                    break               # no free slot
            except PoolExhausted:
                if not self.cache.active.any():
                    raise  # nothing running will ever free pages
                break
            self._queue.pop(0)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy at temperature 0 (first maximum, like ``jnp.argmax``),
        else a draw from ``softmax(logits / temperature)``: the argmax
        of ``p / q`` with ``q ~ Exp(1)`` from the engine's generator,
        which is how ``torch.multinomial`` draws one sample (the same
        generator draws, the same token) without its host-side check of
        the probabilities, a fence."""
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        q = torch.empty_like(probs).exponential_(1,
                                                 generator=self.generator)
        return torch.argmax(probs / q, dim=-1)

    def _up(self, a) -> torch.Tensor:
        """A host numpy array as a tensor on the engine's device, sent so
        that the dispatch does not wait. ``.to(device)`` from pageable
        memory ends in a stream synchronize; from pinned memory with
        ``non_blocking=True`` it is queued on the current stream, before
        the kernels that read it, and PyTorch's caching host allocator
        records an event on that stream so the pinned block is not
        reused before the copy has run. On the CPU an upload is a plain
        copy, so the caller may change its array at once."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _cmask_device(self) -> torch.Tensor:
        """The ``(max_batch, vocab)`` allowed-token mask on the device:
        uploaded through :meth:`_up` (no fence) only when a seating,
        a clear or a commit changed the host mask since the last
        upload."""
        if self._cmask_dirty:
            self._cmask_dev = self._up(self._cmask)
            self._cmask_dirty = False
            self.cmask_uploads += 1
        return self._cmask_dev

    def _adapter_kw(self, rows=slice(None), key: str = "adapter_slots"
                    ) -> Dict:
        """The adapter pool's tensors and the ``rows``' slots, uploaded
        through :meth:`_up`, as a target forward's ``adapters`` and
        ``key`` arguments; empty without a pool."""
        if self.adapters is None:
            return {}
        return {"adapters": self.adapters.arrays,
                key: self._up(self._aslot[rows])}

    def _fetch(self, t: torch.Tensor, commit: bool = True,
               since: Optional[int] = None) -> np.ndarray:
        """The device-to-host fetch: waits for the stream, and counts the
        wait as fence time when it is a commit's (:meth:`take_fence_ns`),
        from ``since`` when the commit's device wait opened earlier (a
        timing hook that waited first)."""
        t0 = time.perf_counter_ns() if since is None else since
        out = t.cpu().numpy()
        if commit:
            self._fence_ns += time.perf_counter_ns() - t0
        return out

    # ---- prefill: dispatch and commit ----
    def prefill_dispatch(self, slot: Optional[int] = None,
                         max_tokens: Optional[int] = None) -> int:
        """Dispatch half of :meth:`prefill_step`: launch one pending
        admission's next chunk and queue an in-flight handle; every host
        mutation (the ``done`` cursor, the prefix registration,
        ``cache.lengths``) waits for :meth:`commit_prefills`. On the
        final chunk of a fresh admission the first token is sampled on
        the device here, so both pipelines draw from the generator in
        the same order; its fetch waits for the commit. A constrained
        request's first token is drawn under its slot's mask row (the
        DFA's start state). A resume replay's final chunk samples
        nothing. ``max_tokens`` caps the
        width, floored to a page multiple (0 below one page). Returns
        the width scheduled (0 when nothing was)."""
        if not self._pending:
            return 0
        cache = self.cache
        if slot is None:
            slot = min(self._pending, key=lambda s: self._pending[s][0].rid)
        req, seq, done = self._pending[slot]
        if any(h["slot"] == slot for h in self._inflight_chunks):
            raise RuntimeError(
                f"prefill_dispatch: slot {slot} already has an in-flight "
                f"chunk — commit it first")
        S = seq.size
        page = cache.page_size
        remaining = S - done
        width = cache.pages_for(remaining) * page
        if self.prefill_chunk is not None:
            width = min(width, self.prefill_chunk)
        if max_tokens is not None:
            cap = (int(max_tokens) // page) * page
            if cap < page:
                return 0
            width = min(width, cap)
        take = min(remaining, width)
        ctx_cap = cache.ctx_cap_pages(cache.pages_for(done)) * page
        chunk = np.zeros((1, width), np.int32)
        chunk[0, :take] = seq[done:done + take]
        # resilience site: before the chunk forward, so a fault commits
        # nothing (neither ``done`` nor a sampled token)
        _fault_point("prefill_chunk")
        t0 = _obs.generate_begin()
        logits, _ = _gen.paged_prefill_chunk(
            self.params, self._up(chunk), cache.pool,
            self._up(cache.block_tables[slot]), self.cfg,
            ctx_cap=ctx_cap, ctx_len=done, chunk_len=take, fused=self.fused,
            **self._adapter_kw(slice(slot, slot + 1), "adapter_slot"))
        self.forwards["prefill"] += 1
        samp = rawmax = None
        if done + take >= S and not req.tokens:
            lg = logits[0]
            if self.constraints and req.constraint is not None:
                # the unmasked argmax rides along for the
                # violation-avoided counter
                rawmax = torch.argmax(lg)
                lg = lg.masked_fill(~self._cmask_device()[slot],
                                    float("-inf"))
            samp = self._sample(lg)
        self._inflight_chunks.append(
            {"slot": slot, "req": req, "seat": int(self._seat[slot]),
             "take": take, "samp": samp, "rawmax": rawmax, "t0": t0,
             "logits": logits, "ttr": _obs.serving_trace_now()})
        return width

    def _commit_chunk(self, h: Dict) -> int:
        """Commit half of one prefill chunk: advance the ``done``
        cursor; on the last chunk publish the prompt to the prefix trie,
        set the slot's length and seed decode — with the fetched first
        token, or on a resume with the request's last token (the
        resumed request must not fork). A constrained request's DFA
        advances with the first token, and its mask row is rebuilt
        unless that token finished it. A chunk whose slot was
        cancelled, or preempted and re-seated, since its dispatch
        commits nothing: the new seating replays the span itself."""
        slot, req, take = h["slot"], h["req"], h["take"]
        # both hooks wait for the chunk's logits when a sink is on:
        # that wait is device time, counted as fence time
        t_f0 = time.perf_counter_ns()
        if self.fused:
            _obs.serving_fused_latency("chunk_flash_attn", h["t0"],
                                       h["logits"])
        _obs.serving_prefill_chunk(h["t0"], h["logits"], take)
        self._fence_ns += time.perf_counter_ns() - t_f0
        ent = self._pending.get(slot)
        if (ent is None or ent[0] is not req
                or int(self._seat[slot]) != h["seat"]):
            return 0
        done = ent[2] + take
        _obs.serving_trace_span(
            req, "prefill_chunk", h["ttr"], replica=self.replica_id,
            slot=slot, seq=len(req.tokens),
            meta={"take": int(take), "done": int(done)} if h["ttr"]
            else None)
        if done < ent[1].size:
            ent[2] = done
            return take
        del self._pending[slot]
        self.cache.register_prefix(slot, req.prompt[0])
        self.cache.lengths[slot] = ent[1].size
        req.finish_reason = None            # clears a transient "preempted"
        if req.tokens:
            self._last[slot] = np.int32(req.tokens[-1])
        else:
            viol = 0
            if h["rawmax"] is not None:
                # one fetch for the sample and the unmasked argmax; the
                # violation reads the PRE-advance row, before
                # _record_token can retire the slot and clear it
                first, raw = self._fetch(
                    torch.stack((h["samp"], h["rawmax"]))).tolist()
                viol = int(not self._cmask[slot, raw])
            else:
                first = int(self._fetch(h["samp"]))
            self._last[slot] = first
            self._record_token(req, first)
            if self.constraints and req.constraint is not None:
                t0m = time.perf_counter_ns()
                req.constraint.advance(first)
                if not req.done:
                    self._mask_row(slot, req)
                _obs.serving_constrain(
                    time.perf_counter_ns() - t0m, viol, 1)
        return take

    def commit_prefills(self) -> int:
        """Commit every in-flight prefill chunk in dispatch order;
        returns the prompt tokens committed."""
        chunks, self._inflight_chunks = self._inflight_chunks, []
        return sum(self._commit_chunk(h) for h in chunks)

    def prefill_step(self, slot: Optional[int] = None,
                     max_tokens: Optional[int] = None) -> int:
        """Advance ONE pending admission (default the oldest) by one
        chunk of at most ``max_tokens`` (page-floored); returns the
        chunk width scheduled (0 when none). The final chunk's logits
        seed the first token (a resume goes on from its last token
        instead), and the finished prompt's pages are published to the
        prefix trie. :meth:`prefill_dispatch` then
        :meth:`commit_prefills`."""
        width = self.prefill_dispatch(slot, max_tokens=max_tokens)
        self.commit_prefills()
        return width

    def _record_token(self, req: GenerationRequest, tok: int):
        req.tokens.append(int(tok))
        if len(req.tokens) == 1:
            _obs.serving_trace_first_token(req)
        if req.eos_token_id is not None and tok == req.eos_token_id:
            self._retire(req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._retire(req, "max_len")

    def _retire(self, req: GenerationRequest, reason: str):
        req.done = True
        req.finish_reason = reason
        _obs.serving_trace_finish(req, reason, replica=self.replica_id)
        self.cache.release(req.slot)
        self._clear_slot(req.slot)
        self._release_adapter(req)
        _obs.serving_retired(1, reason)

    # ---- prefill→decode KV handoff ----
    def export_prefilled(self, req: GenerationRequest,
                         with_kv: bool = True) -> Dict:
        """Export a decode-ready request as a handoff payload: its
        slot, committed length, already-sampled last token and (unless
        ``with_kv=False``, the page-to-page path of
        :meth:`import_prefilled` with ``src_engine``) its live pages'
        bytes (:meth:`~..serving.paged_cache.PagedKVCache.
        export_request`). A pure read: the request keeps running here
        until :meth:`finish_handoff`, so a failed import loses nothing.
        The engine closes no handoff hook: the serving cluster closes
        ``serving_handoff_export`` / ``serving_handoff_import`` around
        this call and :meth:`import_prefilled`, once per handoff."""
        slot = req.slot
        if slot is None or self._slots[slot] is not req:
            raise ValueError(
                f"export_prefilled: request {req.rid} is not running")
        if slot in self._pending:
            raise ValueError(
                f"export_prefilled: request {req.rid} is still "
                f"mid-prefill — hand off only decode-ready slots")
        out = {"rid": req.rid, "slot": slot,
               "length": int(self.cache.lengths[slot]),
               "last": int(self._last[slot])}
        if with_kv:
            out["kv"] = self.cache.export_request(slot)
        return out

    def import_prefilled(self, req: GenerationRequest, payload: Dict,
                         src_engine=None) -> bool:
        """Install an exported request directly into a decode slot: the
        payload's pages scatter into fresh pages (:meth:`~..serving.
        paged_cache.PagedKVCache.import_request`), or, with
        ``src_engine`` (the exporting engine, on the same device), copy
        page to page from its pool (:meth:`~..serving.paged_cache.
        PagedKVCache.import_request_direct`; the payload then needs no
        ``"kv"``). Block table, length and last token end as an in-place
        prefill would leave them, and the prompt's pages publish to THIS
        engine's prefix trie. False when no slot is free; raises
        :class:`PoolExhausted` (nothing changed) when the pool cannot
        cover it. Decode from here is token-identical to having
        prefilled in place. The request's adapter is pinned on THIS
        engine's pool (the KV bytes are adapter-agnostic), and a failed
        page install drops the pin."""
        free = self.cache.free_slots()
        if not free:
            return False
        slot = free[0]
        with self._adapter_pinned(req):
            if src_engine is not None:
                self.cache.import_request_direct(
                    slot, src_engine.cache, payload["slot"],
                    req.prompt.shape[1] + req.max_new_tokens)
            else:
                self.cache.import_request(
                    slot, payload["kv"],
                    req.prompt.shape[1] + req.max_new_tokens)
        self.cache.lengths[slot] = np.int32(payload["length"])
        self._last[slot] = np.int32(payload["last"])
        self._install_slot(slot, req)
        self.cache.register_prefix(slot, req.prompt[0])
        return True

    def finish_handoff(self, req: GenerationRequest, slot: int):
        """Detach a handed-off request from THIS engine after its import
        elsewhere: the slot entry clears first (no two engines ever
        decode the same request), then the pages release; the ones the
        prefix trie shares survive under its references, and the
        request's adapter pin here drops. ``slot`` is the ORIGINAL slot
        from the export payload (``req.slot`` already names the
        importing engine's)."""
        if self._slots[slot] is not req:
            raise ValueError(
                f"finish_handoff: slot {slot} does not hold request "
                f"{req.rid}")
        self._clear_slot(slot)
        self._pending.pop(slot, None)
        self.cache.release(slot)
        # the importing engine took its own pin
        self._release_adapter(req)

    def ready_mask(self) -> np.ndarray:
        """(max_batch,) bool — slots whose sequence is fully in the pool
        and can decode this step."""
        ready = self.cache.active.copy()
        if self._pending:
            ready[list(self._pending)] = False
        return ready

    # ---- decode: dispatch and commit ----
    def has_inflight(self) -> bool:
        """True while a dispatched forward or prefill chunk awaits its
        commit."""
        return self._inflight is not None or bool(self._inflight_chunks)

    def take_fence_ns(self) -> int:
        """Nanoseconds the commits' device-to-host fetches waited since
        the last call (the scheduler's host-versus-device split)."""
        ns, self._fence_ns = self._fence_ns, 0
        return ns

    def _check_idle(self):
        if self._inflight is not None:
            raise RuntimeError("a decode/verify forward is already in "
                               "flight: commit_inflight() first")

    def _handle(self, kind, mask, out, **kw) -> InFlightStep:
        self._inflight = InFlightStep(kind, mask, self._rids.copy(),
                                      self._seat.copy(), out, **kw)
        return self._inflight

    def decode_dispatch(self, mask) -> Optional[InFlightStep]:
        """Run the ragged decode forward for the ``mask`` slots over all
        ``max_batch`` rows (inactive rows write to the trash page) and
        sample, leaving the tokens on the device; None when no slot is
        masked. With constraints every row's logits pass through its
        mask row first (all True for a free row, which leaves it as it
        was). :meth:`commit_inflight` commits it."""
        cache = self.cache
        mask = np.asarray(mask, bool)
        if not mask.any():
            return None
        self._check_idle()
        # resilience sites: step execution (before the launch), then the
        # dispatch seam (after it); neither commits host state
        _fault_point("decode_step")
        t0f = _obs.generate_begin() if self.fused else 0
        logits, _ = _gen.paged_decode_forward(
            self.params, self._up(self._last), cache.pool,
            self._up(cache.block_tables), self._up(cache.lengths),
            self.cfg, active=self._up(mask), fused=self.fused,
            **self._adapter_kw())
        self.forwards["decode"] += 1
        raw = None
        if self.constraints:
            raw = torch.argmax(logits, dim=-1)
            logits = logits.masked_fill(~self._cmask_device(),
                                        float("-inf"))
        out = self._sample(logits)
        _fault_point("dispatch")
        return self._handle("decode", mask, out, t0f=t0f, raw=raw,
                            ttr=_obs.serving_trace_now())

    def _guard(self, h: InFlightStep) -> np.ndarray:
        """(max_batch,) bool: the masked slots that still hold the
        seating they held at dispatch."""
        return (h.mask & (self._rids == h.rids) & (h.rids >= 0)
                & (self._seat == h.seats))

    def _decode_commit(self, h: InFlightStep) -> int:
        """Commit half of :meth:`decode_step`: the one fetch, then the
        guarded slots' lengths and last tokens, and each one's token
        through :meth:`_record_token` (eos / max_len). A constrained
        row's DFA advances with its token and its mask row is rebuilt
        first, before a retirement clears the slot, as the JAX engine
        does; the fetch brings the unmasked argmax too, and each step
        where it was outside the grammar counts as a violation avoided
        (``serving_constrain``). Returns the slots advanced."""
        # resilience sites: the commit seam, then the device-to-host
        # transfer; host state commits only after both
        _fault_point("commit")
        # the device-wait window opens before the timing hook, which
        # waits for h.out when a sink is on
        t_f = time.perf_counter_ns()
        _obs.serving_fused_latency("decode_rope_attn", h.t0f, h.out)
        _fault_point("transfer")
        raw = None
        if h.raw is not None:
            nxt, raw = self._fetch(torch.stack((h.out, h.raw)), since=t_f)
        else:
            nxt = self._fetch(h.out, since=t_f)
        slots = np.flatnonzero(self._guard(h))
        self.cache.lengths[slots] += 1
        self._last[slots] = nxt[slots]
        t1 = _obs.serving_trace_now()
        mask_ns = viol = crows = 0
        for s in slots.tolist():
            req, tok = self._slots[s], int(nxt[s])
            if self.constraints and req.constraint is not None:
                t0m = time.perf_counter_ns()
                crows += 1
                viol += int(not self._cmask[s, int(raw[s])])
                req.constraint.advance(tok)
                self._mask_row(s, req)
                mask_ns += time.perf_counter_ns() - t0m
            if h.ttr:
                # one decode_step span per committed row, closed here
                _obs.serving_trace_span(
                    req, "decode_step", h.ttr, t1,
                    replica=self.replica_id, slot=s,
                    seq=len(req.tokens) + 1)
            self._record_token(req, tok)
        if crows:
            _obs.serving_constrain(mask_ns, viol, crows)
        self._steps += 1
        alloc = self.cache.allocator
        # occupancy reports the rows the dispatched forward computed
        _obs.serving_step(int(h.mask.sum()), self.max_batch,
                          alloc.num_used, alloc.num_usable)
        return int(slots.size)

    def commit_inflight(self) -> int:
        """Commit everything in flight in dispatch order: prefill chunks
        first, then the decode or verify forward; last, fence the
        pending non-blocking swap-outs into the host store. Returns the
        committed units (prompt tokens plus decode slots or verify
        tokens)."""
        n = self.commit_prefills()
        h, self._inflight = self._inflight, None
        if h is not None:
            n += (self._decode_commit(h) if h.kind == "decode"
                  else self._tree_commit(h) if h.kind == "tree"
                  else self._spec_commit(h))
        fence = getattr(self.cache, "fence_swaps", None)
        if fence is not None:
            fence()
        return n

    def decode_step(self, mask) -> int:
        """Advance every ``mask`` slot by one token in one ragged decode
        step over all ``max_batch`` rows (inactive rows write to the
        trash page); returns the number of slots advanced."""
        if self.decode_dispatch(mask) is None:
            return 0
        return self.commit_inflight()

    # ---- speculative decoding ----
    def propose_drafts(self, mask) -> Dict:
        """Drafts for every masked ready slot: ``slot -> up to spec_k
        tokens`` (n-gram), or from the draft model
        (:meth:`_propose_model_drafts`), :class:`TreeDraft` trees under
        ``spec_tree``. Rows with no match, a poor acceptance EMA or no
        token room left are absent and decode plainly."""
        if self.spec is None:
            return {}
        if self.draft_params is not None:
            return self._propose_model_drafts(mask)
        mask = np.asarray(mask, bool)
        drafts: Dict[int, np.ndarray] = {}
        for slot, req in enumerate(self._slots):
            if req is None or not mask[slot]:
                continue
            # a verify commits accepted + 1 tokens: cap the drafts so the
            # commit never overshoots max_new_tokens
            room = req.max_new_tokens - len(req.tokens) - 1
            if room <= 0:
                continue
            d = self.spec.propose(
                slot, req.rid,
                np.concatenate([req.prompt[0],
                                np.asarray(req.tokens, np.int32)]),
                cap=min(self.spec_k, room))
            if d.size:
                drafts[slot] = d
        return drafts

    def _propose_model_drafts(self, mask) -> Dict:
        """The draft-model proposer: ``spec_k`` autoregressive steps of
        the truncated-layer draft model against each row's pages in the
        draft pool.

        Per masked row: (1) admit a draft-pool slot lazily
        (:class:`PoolExhausted` skips drafting: the row decodes
        plainly); (2) catch up — feed the committed context the draft
        pool lacks (all but the last token) through the draft verify
        forward in page-bucketed chunks; steady state needs none, a cold
        slot replays its prompt; (3) ``spec_k`` one-token draft decode
        steps from the last token, each giving the full distribution q:
        the chain token is its argmax (a q-sample when sampling), tree
        mode keeps the top-``width`` candidates of each depth.

        Each draft decode step fetches its logits to the host, as the
        JAX engine's proposer does, so proposing is a fence: a
        speculating dispatch with a draft model waits for the card.

        The draft pool's ``lengths`` stay at its valid prefix; the
        speculative feeds advance a local run length only, and the
        commit moves the valid prefix past exactly the accepted tokens
        that match the fed chain."""
        mask = np.asarray(mask, bool)
        dc = self.draft_cache
        _fault_point("draft_propose")
        rows: Dict[int, np.ndarray] = {}
        rooms: Dict[int, int] = {}
        for slot, req in enumerate(self._slots):
            if req is None or not mask[slot]:
                continue
            room = req.max_new_tokens - len(req.tokens) - 1
            if room <= 0:
                continue
            if not dc.active[slot]:
                total = (req.prompt.shape[1] + req.max_new_tokens
                         + self.spec_k + 1)
                try:
                    dc.admit(slot, total)
                except PoolExhausted:
                    continue        # back-pressure: decode plainly
                dc.lengths[slot] = 0
            rows[slot] = np.concatenate(
                [req.prompt[0], np.asarray(req.tokens, np.int32)])
            rooms[slot] = room
        if not rows:
            return {}
        B, k, temp = self.max_batch, self.spec_k, self.temperature
        # catch-up: page-bucketed verify chunks over the draft model
        # until every row's pool covers its context but the last token
        catchup = 0
        while True:
            need = {s: rows[s].size - 1 - int(dc.lengths[s]) for s in rows}
            cmax = max(need.values())
            if cmax <= 0:
                break
            W = 1
            while W < min(cmax, 128):
                W *= 2
            chunk = np.zeros((B, W), np.int32)
            cmask = np.zeros((B,), bool)
            adv = np.zeros((B,), np.int32)
            for s, c in need.items():
                if c <= 0:
                    continue
                c = min(c, W)
                st = int(dc.lengths[s])
                chunk[s, :c] = rows[s][st:st + c]
                cmask[s] = True
                adv[s] = c
                catchup += c
            ctx_cap = dc.ctx_cap_pages(dc.pages_for(
                int(dc.lengths[cmask].max()))) * dc.page_size
            _gen.paged_verify_forward(
                self.draft_params, self._up(chunk), dc.pool,
                self._up(dc.block_tables), self._up(dc.lengths),
                self.draft_cfg, ctx_cap=ctx_cap,
                active=self._up(cmask), fused=self.fused)
            self.forwards["draft_catchup"] += 1
            dc.lengths[cmask] += adv[cmask]
        # the autoregressive draft loop
        amask = np.zeros((B,), bool)
        for s in rows:
            amask[s] = True
            self._draft_base[s] = rows[s].size
        run_len = dc.lengths.copy()
        x = self._last.copy()
        tree_w = self.spec_tree[0] if self.spec_tree is not None else 0
        chains: Dict[int, list] = {s: [] for s in rows}
        fed: Dict[int, list] = {s: [] for s in rows}
        qs = ({s: [] for s in rows}
              if temp != 0.0 and not tree_w else None)
        cands = {s: [] for s in rows} if tree_w else None
        for i in range(k):
            logits, _ = _gen.paged_decode_forward(
                self.draft_params, self._up(x), dc.pool,
                self._up(dc.block_tables), self._up(run_len),
                self.draft_cfg, active=self._up(amask),
                fused=self.fused)
            self.forwards["draft_decode"] += 1
            logits = self._fetch(logits.float(), commit=False)
            run_len[amask] += 1
            for s in rows:
                z = logits[s].astype(np.float64)
                if tree_w:
                    top = np.argsort(z)[::-1][:tree_w]
                    cands[s].append(top.astype(np.int32))
                    nxt = int(top[0])
                elif temp != 0.0:
                    z = z / temp
                    z -= z.max()
                    q = np.exp(z)
                    q /= q.sum()
                    nxt = int(self._accept_rng.choice(q.size, p=q))
                    qs[s].append(q)
                else:
                    nxt = int(np.argmax(z))
                if len(chains[s]) < min(k, rooms[s]):
                    chains[s].append(nxt)
                if i < k - 1:
                    fed[s].append(nxt)
                x[s] = nxt
        out: Dict = {}
        drafted = 0
        for s in rows:
            self._draft_chain[s] = np.asarray(fed[s], np.int32)
            if tree_w:
                t = build_comb_tree(int(self._last[s]),
                                    np.asarray(chains[s], np.int32),
                                    [c[1:] for c in cands[s]])
                t = t[:min(t.size, rooms[s])]
                if t.size:
                    out[s] = t
                    drafted += t.size
            else:
                d = np.asarray(chains[s], np.int32)
                if qs is not None:
                    self._draft_q[s] = np.stack(qs[s])[:d.size]
                if d.size:
                    out[s] = d
                    drafted += d.size
        _obs.serving_draft_propose(len(rows), drafted, catchup)
        _obs.serving_draft_pool(dc.allocator.num_used,
                                dc.allocator.num_usable)
        return out

    def spec_step(self, mask, drafts: Optional[Dict] = None) -> int:
        """The speculative sibling of :meth:`decode_step`: draft, verify
        every masked row's drafts in ONE batched forward, commit each
        row's longest accepted prefix (or root path) plus the bonus
        token. Rows without drafts ride the same forward and commit
        their plain token; when no masked row drafted this is a plain
        decode step. Rejected drafts need no rollback: ``lengths``
        advances past the accepted tokens only. Returns the number of
        tokens committed."""
        if self.spec_dispatch(mask, drafts) is None:
            return 0
        return self.commit_inflight()

    def spec_plan_widths(self, mask) -> Dict[int, int]:
        """Pessimistic per-row verify widths for budget planning before
        drafts can be proposed: the overlapped scheduler plans step N+1
        before step N commits, so the history the proposer needs is not
        final. Charging ``min(spec_k, room)`` per ready row (tree
        speculation: its node count) keeps the token budget a hard
        ceiling; the real drafts are proposed after the commit and
        trimmed to the planned allowance. Rows with no token room are
        absent, as in :meth:`propose_drafts`."""
        if self.spec is None:
            return {}
        mask = np.asarray(mask, bool)
        nodes = (self._tree_T - 1 if self.spec_tree is not None
                 else self.spec_k)
        out: Dict[int, int] = {}
        for slot, req in enumerate(self._slots):
            if req is None or not mask[slot]:
                continue
            room = req.max_new_tokens - len(req.tokens) - 1
            if room > 0:
                out[slot] = min(nodes, room)
        return out

    def _ctx_cap(self, mask) -> int:
        """Power-of-two page bucket of the longest masked context (the
        chunk program's rule; ready rows hold >= 1 token), from the host
        lengths as they stand at dispatch."""
        cache = self.cache
        return cache.ctx_cap_pages(cache.pages_for(
            int(cache.lengths[mask].max()))) * cache.page_size

    def _targets(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy verify targets at every position, or the f32 logits
        the rejection sampler needs when sampling."""
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return logits.float()

    def spec_dispatch(self, mask,
                      drafts: Optional[Dict] = None
                      ) -> Optional[InFlightStep]:
        """Dispatch half of :meth:`spec_step`: propose (unless given
        ``drafts``, for example trimmed to a scheduler's per-row
        allowance), build the (B, spec_k + 1) chunk and run the verify
        forward. Falls back to :meth:`decode_dispatch` when no masked
        row drafted."""
        if self.spec is None:
            return self.decode_dispatch(mask)
        cache = self.cache
        mask = np.asarray(mask, bool)
        if not mask.any():
            return None
        self._check_idle()
        if drafts is None:
            drafts = self.propose_drafts(mask)
        if self.spec_tree is not None:
            return self._tree_dispatch(mask, drafts)
        drafts = {s: np.asarray(d, np.int32) for s, d in drafts.items()
                  if len(d) and mask[s]}
        if not drafts:
            return self.decode_dispatch(mask)
        qs = None
        if self.draft_params is not None and self.temperature != 0.0:
            qs = {s: self._draft_q[s][:d.size]
                  for s, d in drafts.items() if s in self._draft_q}
        B, T = self.max_batch, self.spec_k + 1
        chunk = np.zeros((B, T), np.int32)
        chunk[:, 0] = self._last
        dlen = np.zeros((B,), np.int32)
        for s, d in drafts.items():
            chunk[s, 1:1 + d.size] = d
            dlen[s] = d.size
        ctx_cap = self._ctx_cap(mask)
        _fault_point("verify_step")
        t0 = _obs.generate_begin()
        logits, _ = _gen.paged_verify_forward(
            self.params, self._up(chunk), cache.pool,
            self._up(cache.block_tables), self._up(cache.lengths),
            self.cfg, ctx_cap=ctx_cap,
            active=self._up(mask), fused=self.fused, **self._adapter_kw())
        self.forwards["verify"] += 1
        out = self._targets(logits)
        _fault_point("dispatch")
        return self._handle("spec", mask, out, drafts=drafts, dlen=dlen,
                            qs=qs, t0=t0, ttr=_obs.serving_trace_now())

    def _advance_draft(self, slot: int, toks, a: int):
        """Move the draft pool's valid prefix past the accepted tokens
        that match the chain fed through the draft model; a mismatched
        tail is fed again by the next catch-up."""
        if self.draft_cache is None or slot not in self._draft_chain:
            return
        ch = self._draft_chain.pop(slot)
        m = 0
        while m < min(a, ch.size) and int(toks[m]) == int(ch[m]):
            m += 1
        self.draft_cache.lengths[slot] = int(self._draft_base[slot]) + m

    def _commit_tokens(self, slot: int, req: GenerationRequest, toks,
                       a: int) -> int:
        """The last token's KV and ``a`` accepted drafts become context;
        the bonus token becomes the new last. Returns tokens recorded."""
        self.cache.lengths[slot] += a + 1
        self._last[slot] = np.int32(toks[-1])
        n = 0
        for tok in toks:
            self._record_token(req, int(tok))
            n += 1
            if req.done:
                break                  # eos/max_len: drop the tail
        return n

    def _spec_commit(self, h: InFlightStep) -> int:
        """Commit half of :meth:`spec_step`: each row's longest accepted
        prefix plus the bonus token (rejection sampling at temperature
        > 0, against the draft model's q when it has one). Slots whose
        seating changed since the dispatch are skipped."""
        _fault_point("commit")
        t_f = time.perf_counter_ns()
        if self.fused:
            _obs.serving_fused_latency("verify_flash_attn", h.t0, h.out)
        _fault_point("transfer")
        # (B, T) targets, or (B, T, V) logits when sampling
        out = self._fetch(h.out, since=t_f)
        t1 = time.perf_counter_ns()        # device fence: verify done
        sampled = self.temperature != 0.0
        valid = self._guard(h)
        committed = drafted = accepted = 0
        slots = np.flatnonzero(valid).tolist()
        for slot in slots:
            req = self._slots[slot]
            j = int(h.dlen[slot])
            d = h.drafts.get(slot)
            if sampled:
                q = h.qs.get(slot) if h.qs is not None else None
                toks, a = rejection_sample_tokens(
                    out[slot, :j + 1], d if j else None,
                    self.temperature, self._accept_rng,
                    q=(q[:j] if q is not None and j else None))
            else:
                a = longest_accepted_prefix(d, out[slot]) if j else 0
                toks = ((list(d[:a]) if j else [])
                        + [int(out[slot, a])])
            self._advance_draft(slot, toks, a)
            committed += self._commit_tokens(slot, req, toks, a)
            if j:
                drafted += j
                accepted += a
                self.spec.observe(slot, req.rid, j, a)
            if h.ttr:
                _obs.serving_trace_span(
                    req, "spec_verify", h.ttr, replica=self.replica_id,
                    slot=slot, seq=len(req.tokens),
                    meta={"drafted": j, "accepted": int(a)})
        if sampled and drafted:
            _obs.serving_sample_accept(drafted, accepted)
        self._steps += 1
        _obs.serving_spec_verify(h.t0, out, len(slots), drafted, accepted,
                                 t1_ns=t1)
        alloc = self.cache.allocator
        _obs.serving_step(len(slots), self.max_batch, alloc.num_used,
                          alloc.num_usable)
        return committed

    def _tree_dispatch(self, mask, trees) -> Optional[InFlightStep]:
        """Dispatch half of the tree step: pack every masked row's tree
        into one (B, T) chunk (node 0 the last token), with per-node
        depths and ancestor matrices, and run the ONE tree-mode verify
        forward. Rows without a tree ride along as a root-only tree; pad
        nodes hang off the root. No tree at all: plain decode."""
        cache = self.cache
        trees = {s: t for s, t in trees.items()
                 if mask[s] and isinstance(t, TreeDraft) and t.size}
        if not trees:
            return self.decode_dispatch(mask)
        B, T = self.max_batch, self._tree_T
        chunk = np.zeros((B, T), np.int32)
        chunk[:, 0] = self._last
        depths = np.ones((B, T), np.int32)
        depths[:, 0] = 0
        anc = np.zeros((B, T, T), bool)
        anc[:, np.arange(T), np.arange(T)] = True
        anc[:, :, 0] = True             # pad nodes hang off the root
        for s, t in trees.items():
            n = t.tokens.size
            chunk[s, :n] = t.tokens
            depths[s, :n] = tree_depths(t.parents)
            anc[s, :n, :n] = tree_ancestor_matrix(t.parents)
        ctx_cap = self._ctx_cap(mask)
        _fault_point("tree_verify")
        t0 = _obs.generate_begin()
        logits, rows = _gen.paged_verify_forward(
            self.params, self._up(chunk), cache.pool,
            self._up(cache.block_tables), self._up(cache.lengths),
            self.cfg, ctx_cap=ctx_cap,
            active=self._up(mask), fused=self.fused,
            tree_depth=self._up(depths), tree_mask=self._up(anc),
            **self._adapter_kw())
        self.forwards["tree"] += 1
        out = self._targets(logits)
        _fault_point("dispatch")
        return self._handle("tree", mask, out, drafts=trees, rows=rows,
                            t0=t0, ttr=_obs.serving_trace_now())

    def _tree_commit(self, h: InFlightStep) -> int:
        """Commit half of the tree step: each row's longest accepted
        root path (greedy walk, or sequential point-mass rejection down
        the tree when sampling), its nodes' KV placed at the PRE-commit
        lengths (bit-identical to a linear verify of the path), then the
        bookkeeping. Rejected nodes were never placed; slots whose
        seating changed since the dispatch place nothing (path length
        0) and commit nothing."""
        cache = self.cache
        _fault_point("commit")
        t_f = time.perf_counter_ns()
        if self.fused:
            _obs.serving_fused_latency("verify_flash_attn", h.t0, h.out)
        _fault_point("transfer")
        # (B, T) targets, or (B, T, V) logits when sampling
        out = self._fetch(h.out, since=t_f)
        t1 = time.perf_counter_ns()
        sampled = self.temperature != 0.0
        B, T = self.max_batch, self._tree_T
        path_nodes = np.zeros((B, T), np.int32)
        path_len = np.zeros((B,), np.int32)
        base_len = cache.lengths.copy()
        plans = []
        for slot in np.flatnonzero(self._guard(h)).tolist():
            req = self._slots[slot]
            t = h.drafts.get(slot)
            if t is None:
                # un-drafted row: exactly the plain token at the root
                if sampled:
                    z = out[slot, 0].astype(np.float64) / self.temperature
                    z -= z.max()
                    p = np.exp(z)
                    p /= p.sum()
                    toks = [int(self._accept_rng.choice(p.size, p=p))]
                else:
                    toks = [int(out[slot, 0])]
                path, a = [0], 0
            elif sampled:
                path, toks, a = tree_rejection_sample(
                    t.tokens, t.parents, out[slot], self.temperature,
                    self._accept_rng)
            else:
                path, toks, a = longest_accepted_path(
                    t.tokens, t.parents, out[slot])
            path_nodes[slot, :len(path)] = path
            path_len[slot] = len(path)
            plans.append((slot, req, t, toks, a))
        # placement first, against the pre-commit tables and lengths
        # (retirement below resets them for finished rows)
        _gen.paged_tree_commit(
            cache.pool, h.rows, self._up(cache.block_tables),
            self._up(base_len), self._up(path_nodes), self._up(path_len))
        committed = drafted = accepted = 0
        paths = []
        for slot, req, t, toks, a in plans:
            self._advance_draft(slot, toks, a)
            committed += self._commit_tokens(slot, req, toks, a)
            if t is not None:
                drafted += t.size
                accepted += a
                paths.append(a + 1)
                self.spec.observe(slot, req.rid, t.size, a)
            if h.ttr:
                _obs.serving_trace_span(
                    req, "tree_verify", h.ttr, replica=self.replica_id,
                    slot=slot, seq=len(req.tokens),
                    meta={"nodes": t.size if t is not None else 0,
                          "accepted": int(a)})
        if sampled and drafted:
            _obs.serving_sample_accept(drafted, accepted)
        self._steps += 1
        _obs.serving_tree_verify(h.t0, out, len(plans), drafted, accepted,
                                 paths, t1_ns=t1)
        alloc = cache.allocator
        _obs.serving_step(len(plans), self.max_batch, alloc.num_used,
                          alloc.num_usable)
        return committed

    def step(self) -> bool:
        """Admit (FIFO), advance chunked prefill by one chunk, then
        advance every fully prefilled slot by one token. Returns False
        when no work remains."""
        self._admit()
        self.prefill_step()
        advance = (self.spec_step if self.spec is not None
                   else self.decode_step)
        if advance(self.ready_mask()) == 0:
            return bool(self._queue or self._pending
                        or self.cache.active.any())
        return bool(self._queue) or bool(self.cache.active.any())

    def run(self) -> None:
        """Drive steps until every submitted request finished."""
        while self.step():
            pass

    # ---- scheduler-facing state ----
    @property
    def idle(self) -> bool:
        """Nothing queued, mid-prefill or decoding: the state a
        scheduler requires when it attaches."""
        return not (self._queue or self._pending
                    or self.cache.active.any())

    def running_requests(self) -> List[GenerationRequest]:
        """Live requests holding slots (mid-prefill ones included): the
        preemption-victim candidates."""
        return [r for r in self._slots if r is not None]

    def queued_requests(self) -> List[GenerationRequest]:
        """Requests in the engine's own FIFO queue (empty under a
        scheduler, which keeps its own queues)."""
        return list(self._queue)

    def pending_prefills(self) -> Dict[int, tuple]:
        """``slot -> (request, remaining_tokens)`` for every admission
        whose sequence is not yet fully in the pool."""
        return {s: (ent[0], int(ent[1].size - ent[2]))
                for s, ent in self._pending.items()}

    def generate(self, prompts, max_new_tokens: int = 16) -> List[np.ndarray]:
        """Submit all, run to completion, return each request's
        prompt+generated row (submission order)."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens)
                for p in prompts]
        self.run()
        return [r.output for r in reqs]

    def stats(self) -> Dict:
        s = self.cache.allocator.stats()
        s["steps"] = self._steps
        s["prefill_chunks"] = self.forwards["prefill"]
        s["queued"] = len(self._queue)
        s["active_slots"] = int(self.cache.active.sum())
        s["pending_prefills"] = len(self._pending)
        if self.weight_bits is not None:
            s["weight_bits"] = self.weight_bits
        if self.fused:
            s["fused_kernels"] = True
        s["cow_copies"] = self.cache.cow_copies
        if getattr(self.cache, "host", None) is not None:
            s.update(self.cache.tier_stats())
        if self.cache.prefix is not None:
            s["prefix_evictions_total"] = self.cache.prefix.evictions_total
        s["forwards"] = dict(self.forwards)
        if self.spec is not None:
            s.update(self.spec.stats())
        if self.draft_cache is not None:
            s["draft_layers"] = self.draft_layers
            da = self.draft_cache.allocator
            s["draft_pool_pages_used"] = da.num_used
            s["draft_pool_pages_usable"] = da.num_usable
        if self.spec_tree is not None:
            s["tree_width"], s["tree_depth"] = self.spec_tree
            s["tree_nodes"] = self._tree_T - 1
        if self.adapters is not None:
            s.update(self.adapters.stats())
        return s
