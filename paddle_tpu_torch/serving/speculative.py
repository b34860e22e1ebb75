"""Speculative decoding on the host: n-gram drafting, greedy and
sampled acceptance, the adaptive per-row controller, and token trees.

Counterpart of ``paddle_tpu/serving/speculative.py``, which is pure
numpy; the port keeps its own copy, function for function, so that it
imports nothing of the JAX package. The engine
(:class:`paddle_tpu_torch.inference.ContinuousBatchingEngine` with
``spec_k`` / ``draft_layers`` / ``spec_tree``) drafts with these
proposers, verifies every row's drafts in one batched forward
(:func:`paddle_tpu_torch.models.generate.paged_verify_forward`) and
commits with these acceptance rules:

- :class:`NgramProposer` / :class:`Speculator`: prompt-lookup drafting
  with a per-row acceptance EMA that scales the draft length;
- :func:`longest_accepted_prefix`: greedy linear acceptance (the first
  mismatch's target is the bonus token), so greedy speculation is
  token-identical to plain greedy decode;
- :func:`rejection_sample_tokens`: sampled acceptance, min(1, p/q) with
  the corrected residual, for point-mass (n-gram) or real (draft model)
  proposals;
- :class:`TreeDraft`, :func:`build_comb_tree`, :func:`tree_depths`,
  :func:`tree_ancestor_matrix`: the draft model's comb token tree, its
  per-node positions and the ancestor mask the tree verify attends
  under; :func:`longest_accepted_path` / :func:`tree_rejection_sample`
  pick the committed root path.

No torch, no device state: every function takes and returns numpy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max()
    e = np.exp(z, dtype=np.float64)
    return e / e.sum()


def rejection_sample_tokens(logits: np.ndarray, drafts,
                            temperature: float,
                            rng: np.random.Generator,
                            q: Optional[np.ndarray] = None
                            ) -> Tuple[list, int]:
    """Standard speculative REJECTION SAMPLING, specialized
    to a deterministic draft proposer — the lift of spec decode's
    greedy-only restriction.

    ``logits``: (T, V) f32 verify-forward outputs — row ``i`` is the
    target model's distribution over the token AFTER ``drafts[:i]``
    (position 0 conditions on the committed context alone). ``drafts``:
    up to T-1 proposed tokens. Returns ``(tokens, accepted)`` where
    ``tokens`` is the committed run (``accepted`` drafts plus exactly
    one corrective/bonus token) — the sampled sibling of the greedy
    ``longest_accepted_prefix + bonus`` commit.

    The math is the min(1, p/q) acceptance test with the corrected
    residual distribution. With ``q=None`` the proposer is taken to be
    DETERMINISTIC (the n-gram case): its draft distribution is a point
    mass at the proposed token x, min(1, p(x)/q(x)) = p(x), and the
    residual norm_+(p - q) zeroes exactly the x entry of p and
    renormalizes. With a REAL draft distribution (``q`` is a (j, V)
    array of the draft model's sampling probabilities, row i the
    distribution draft i was drawn from), draft i is accepted with
    probability min(1, p(x)/q(x)) and on rejection the corrective
    token samples the residual norm_+(p - q) — note the residual
    subtracts the WHOLE q row, not just the x entry. Either way the
    committed tokens are distributed EXACTLY as p — the output
    distribution matches plain sampled decode token-for-token in law
    (the JAX package's distribution and real-q property tests gate
    this), which is what makes temperature>0 traffic eligible for the 1+k speculative speedup.

    Real-q edge cases:
    q(x) <= 0 with p(x) > 0 is the limit min(1, p/q) -> 1 (accept);
    q(x) <= 0 with p(x) == 0 rejects (the ratio's 0/0 limit along
    q -> 0+ is p/q with p = 0). A residual that sums to <= 0 means
    p <= q everywhere, i.e. p == q up to float fuzz (both sum to 1),
    where acceptance is certain — treat the draft as accepted rather
    than dividing by ~0.

    ``temperature == 0`` is the greedy limit: p collapses onto the
    argmax, acceptance degenerates to draft == argmax and the
    corrective token to the argmax itself — token-identical to
    :func:`longest_accepted_prefix` + bonus by construction (gated)."""
    logits = np.asarray(logits, np.float64)
    drafts = np.asarray(drafts if drafts is not None else (),
                        np.int64).reshape(-1)
    j = int(drafts.size)
    if temperature == 0.0:
        targets = np.argmax(logits, axis=-1)
        a = longest_accepted_prefix(drafts, targets) if j else 0
        return [int(t) for t in drafts[:a]] + [int(targets[a])], a
    if q is not None:
        q = np.asarray(q, np.float64)
        if q.ndim != 2 or q.shape[0] < j:
            raise ValueError(
                f"rejection_sample_tokens: q must cover all {j} drafts, "
                f"got shape {q.shape}")
    for i in range(j):
        p = _softmax(logits[i] / temperature)
        x = int(drafts[i])
        if q is None:
            accept_p = p[x]                       # point-mass draft
        else:
            qx = q[i, x]
            if qx <= 0.0:
                # q -> 0+ limit of min(1, p/q): certain accept when the
                # target puts any mass on x, certain reject when p(x)=0
                accept_p = 1.0 if p[x] > 0.0 else 0.0
            else:
                accept_p = min(1.0, p[x] / qx)
        if rng.random() < accept_p:
            continue                              # accept draft i
        if q is None:
            resid = p.copy()
            resid[x] = 0.0
        else:
            resid = np.maximum(p - q[i], 0.0)
        s = resid.sum()
        if s <= 0.0:
            if q is None:
                # p was (numerically) a point mass at x — the accept
                # draw can only have failed by float fuzz; treat as
                # accepted
                continue
            # p <= q everywhere with both summing to 1 means p == q up
            # to float fuzz: the residual is empty and a fresh draw
            # from p IS the exact corrective distribution (this also
            # covers the q(x)=0, p(x)=0 reject, where x itself must
            # not be committed)
            tok = int(rng.choice(p.size, p=p))
            return [int(t) for t in drafts[:i]] + [tok], i
        tok = int(rng.choice(resid.size, p=resid / s))
        return [int(t) for t in drafts[:i]] + [tok], i
    # every draft accepted: the bonus token samples from the
    # distribution at the position after the last draft — exactly what
    # plain sampled decode would draw there
    p = _softmax(logits[j] / temperature)
    return ([int(t) for t in drafts]
            + [int(rng.choice(p.size, p=p))], j)


def longest_accepted_prefix(drafts: np.ndarray,
                            targets: np.ndarray) -> int:
    """Number of leading draft tokens that match the greedy verify
    targets: ``drafts[i]`` is accepted iff it equals ``targets[i]``
    (the argmax logits at chunk position ``i``, i.e. the token plain
    greedy decode would emit after the drafts before it) and every
    earlier draft was accepted."""
    drafts = np.asarray(drafts)
    j = drafts.size
    if j == 0:
        return 0
    neq = drafts != np.asarray(targets)[:j]
    return int(j if not neq.any() else np.argmax(neq))


class NgramProposer:
    """Model-free prompt-lookup drafting: propose the continuation of
    the most recent PRIOR occurrence of the history's last n-gram.

    Tries the longest n-gram first (``ngram_max`` down to
    ``ngram_min``) — a longer match is a stronger repetition signal —
    and returns the tokens that followed it, up to ``k``. Pure numpy on
    the host (one sliding-window compare per n); the engine calls this
    once per speculating row per step, so the cost is O(history x n)
    bytes of compare, trivial next to a decode forward."""

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        if not (1 <= ngram_min <= ngram_max):
            raise ValueError(
                f"NgramProposer: need 1 <= ngram_min ({ngram_min}) <= "
                f"ngram_max ({ngram_max})")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        """history: 1-D int32 ``prompt + generated`` tokens; returns up
        to ``k`` draft tokens (possibly empty — no match is a normal
        outcome, the row just decodes plainly this step)."""
        history = np.asarray(history, np.int32).reshape(-1)
        empty = np.zeros((0,), np.int32)
        if k <= 0:
            return empty
        for n in range(min(self.ngram_max, history.size - 1),
                       self.ngram_min - 1, -1):
            tail = history[-n:]
            # windows over history[:-1]: a match at i guarantees at
            # least one continuation token and excludes the tail's own
            # (self-)occurrence at the very end
            win = np.lib.stride_tricks.sliding_window_view(
                history[:-1], n)
            hits = np.nonzero((win == tail).all(axis=1))[0]
            if hits.size:
                i = int(hits[-1])                 # most recent match
                return history[i + n:i + n + k].copy()
        return empty


class Speculator:
    """Per-row speculation state: proposer + windowed acceptance-rate
    EMA + adaptive draft length.

    ``k_for`` scales each row's proposal with its EMA (optimistic start
    at 1.0): ``round(ema * max_k)`` while the EMA stays at or above
    ``min_rate``; below it the row falls back to plain decode (k=0) and
    re-probes with a single draft after ``probe_every`` opportunities —
    the probe stays OFFERED until one actually verifies (a probe the
    budget trims or that finds no n-gram match doesn't re-arm the
    counter), so a row that stops repeating stops paying verify width,
    and one that starts repeating again is rediscovered even under a
    tight token budget. State is keyed by the occupying request's rid
    and resets when a slot changes tenants.

    Counters (``drafted_total`` / ``accepted_total`` /
    ``rejected_total`` / ``verify_steps``) feed the
    engine's ``stats()`` and the acceptance-rate record."""

    def __init__(self, max_k: int, *, ngram_max: int = 3,
                 ngram_min: int = 1, ema_beta: float = 0.5,
                 min_rate: float = 0.125, probe_every: int = 8,
                 proposer: Optional[NgramProposer] = None):
        if max_k < 1:
            raise ValueError(f"Speculator: max_k must be >= 1, got "
                             f"{max_k} (spec_k=0 disables speculation "
                             f"at the engine instead)")
        if not (0.0 <= ema_beta < 1.0):
            raise ValueError(f"ema_beta must be in [0, 1), got {ema_beta}")
        self.max_k = max_k
        self.proposer = proposer or NgramProposer(ngram_max, ngram_min)
        self.ema_beta = float(ema_beta)
        self.min_rate = float(min_rate)
        self.probe_every = int(probe_every)
        self._ema: Dict[int, float] = {}          # slot -> acceptance EMA
        self._rid: Dict[int, int] = {}            # slot -> tenant rid
        self._since_probe: Dict[int, int] = {}
        self.drafted_total = 0
        self.accepted_total = 0
        self.rejected_total = 0
        self.verify_steps = 0

    def _sync_slot(self, slot: int, rid: int):
        if self._rid.get(slot) != rid:
            self._rid[slot] = rid
            self._ema[slot] = 1.0                 # optimistic start
            self._since_probe[slot] = 0

    def k_for(self, slot: int, rid: int) -> int:
        """Adaptive draft length for this row, 0 = plain decode."""
        self._sync_slot(slot, rid)
        ema = self._ema[slot]
        if ema < self.min_rate:
            self._since_probe[slot] += 1
            if self._since_probe[slot] >= self.probe_every:
                # the counter re-arms in observe(), NOT here: a probe
                # the budget trims away (or that finds no n-gram match)
                # never executes, so it keeps being OFFERED until one
                # actually verifies — otherwise a tight token_budget
                # could silently disable speculation for a row whose
                # history has resumed repeating
                return 1                          # periodic re-probe
            return 0
        return max(1, min(self.max_k, int(round(ema * self.max_k))))

    def propose(self, slot: int, rid: int, history: np.ndarray,
                cap: Optional[int] = None) -> np.ndarray:
        """Draft tokens for the row occupying ``slot`` (``cap``
        additionally bounds the length, e.g. the request's remaining
        ``max_new_tokens`` room)."""
        k = self.k_for(slot, rid)
        if cap is not None:
            k = min(k, int(cap))
        if k <= 0:
            return np.zeros((0,), np.int32)
        return self.proposer.propose(history, k)

    def observe(self, slot: int, rid: int, proposed: int, accepted: int):
        """Fold one verify outcome into the row's EMA + the counters."""
        if proposed <= 0:
            return
        self._sync_slot(slot, rid)
        self._since_probe[slot] = 0               # executed: re-arm probe
        rate = accepted / proposed
        b = self.ema_beta
        self._ema[slot] = b * self._ema[slot] + (1.0 - b) * rate
        self.drafted_total += proposed
        self.accepted_total += accepted
        self.rejected_total += proposed - accepted
        self.verify_steps += 1

    @property
    def acceptance_rate(self) -> float:
        """Lifetime accepted/drafted ratio (0.0 before any verify)."""
        return (self.accepted_total / self.drafted_total
                if self.drafted_total else 0.0)

    def stats(self) -> Dict:
        return {
            "spec_drafted_total": self.drafted_total,
            "spec_accepted_total": self.accepted_total,
            "spec_rejected_total": self.rejected_total,
            "spec_verify_steps": self.verify_steps,
            "spec_acceptance_rate": round(self.acceptance_rate, 4),
        }


# ---------------------------------------------------------------------------
# Tree speculation: token trees, ancestor masks, path acceptance
# ---------------------------------------------------------------------------


class TreeDraft:
    """A per-row token tree proposal: node 0 is the ROOT (the row's
    last committed token, re-scored just like ``chunk[:, 0]`` on the
    linear path) and nodes 1..n-1 are draft tokens. Topology is encoded
    as per-node parent indices with ``parents[0] == -1`` and
    ``parents[i] < i`` (parents precede children), so any PREFIX of the
    node list is itself a valid tree.

    The node ORDER is the budget-trim contract: the root path (the
    draft model's top-1 chain) comes first, then sibling leaves in
    decreasing priority. ``d.size`` is the DRAFT node count (n - 1,
    the extra verify positions the row charges against the token
    budget — same accounting as a linear draft of that length), and
    ``d[:k]`` keeps the first k draft nodes, so when
    a token-budget planner trims a
    row's width it sheds sibling leaves and chain tail first and the
    root-path prefix always survives — the planner and scheduler use
    exactly the ``.size`` / ``[:k]`` surface they already use for
    linear ``np.ndarray`` drafts and need no tree awareness."""

    __slots__ = ("tokens", "parents")

    def __init__(self, tokens, parents):
        self.tokens = np.asarray(tokens, np.int32).reshape(-1)
        self.parents = np.asarray(parents, np.int32).reshape(-1)
        n = self.tokens.size
        if self.parents.size != n or n < 1:
            raise ValueError(
                f"TreeDraft: need matching non-empty tokens/parents, "
                f"got {self.tokens.size}/{self.parents.size}")
        if self.parents[0] != -1 or (n > 1 and not (
                (self.parents[1:] >= 0)
                & (self.parents[1:] < np.arange(1, n))).all()):
            raise ValueError(
                "TreeDraft: parents must be topological (parents[0] "
                f"== -1, parents[i] < i), got {self.parents.tolist()}")

    @property
    def size(self) -> int:
        """Draft-node count (excludes the root) — the token-budget
        charge, mirroring ``np.ndarray.size`` of a linear draft."""
        return int(self.tokens.size - 1)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, key) -> "TreeDraft":
        """``d[:k]`` keeps the first k DRAFT nodes (plus the root).
        Only leading slices are meaningful — the chain-first node order
        makes every such prefix parent-closed."""
        if not isinstance(key, slice) or key.start not in (None, 0) \
                or key.step not in (None, 1):
            raise TypeError("TreeDraft supports only leading slices "
                            "([:k]) — the budget-trim contract")
        k = self.size if key.stop is None else max(0, min(
            int(key.stop), self.size))
        return TreeDraft(self.tokens[:k + 1], self.parents[:k + 1])

    def depths(self) -> np.ndarray:
        return tree_depths(self.parents)

    def __repr__(self):
        return (f"TreeDraft(n={self.tokens.size}, "
                f"depth={int(self.depths().max())})")


def build_comb_tree(root_token: int, chain, siblings=None) -> TreeDraft:
    """Assemble the draft model's proposal into the COMB topology the
    engine verifies: a top-1 chain ``chain[0..d-1]`` hanging off the
    root, plus optional sibling leaves — ``siblings[i]`` are the
    lower-ranked alternatives to ``chain[i]``, children of the same
    parent (chain node i, i.e. the root for i = 0). Chain nodes are
    emitted first, then siblings by depth, so budget trimming drops
    the deepest-priority leaves first and the chain tail last."""
    chain = np.asarray(chain, np.int32).reshape(-1)
    tokens = [int(root_token)] + [int(t) for t in chain]
    parents = [-1] + list(range(chain.size))
    for d, sib in enumerate(siblings or ()):
        if d >= chain.size:
            break
        for t in np.asarray(sib, np.int32).reshape(-1):
            tokens.append(int(t))
            parents.append(d)                     # same parent as chain[d]
    return TreeDraft(tokens, parents)


def tree_depths(parents: np.ndarray) -> np.ndarray:
    """Per-node depth (root = 0) — the verify position offset of each
    node: node i scores at sequence position ``lengths + depth[i]``."""
    parents = np.asarray(parents, np.int64).reshape(-1)
    depth = np.zeros(parents.size, np.int32)
    for i in range(1, parents.size):
        depth[i] = depth[parents[i]] + 1
    return depth


def tree_ancestor_matrix(parents: np.ndarray) -> np.ndarray:
    """(n, n) bool ancestor-or-self matrix: ``anc[i, j]`` iff node j
    lies on the root path of node i (including i == j). Row i is node
    i's attention allowance over the in-flight tree chunk — the mask
    :func:`paddle_tpu_torch.models.generate.paged_verify_forward` folds into
    flash_chunk_attention. For a pure chain this is lower-triangular
    ones, i.e. exactly the causal mask the linear verify path already
    applies (the parity anchor of the tree path)."""
    parents = np.asarray(parents, np.int64).reshape(-1)
    n = parents.size
    anc = np.eye(n, dtype=bool)
    for i in range(1, n):
        anc[i] = anc[parents[i]]
        anc[i, i] = True
    return anc


def longest_accepted_path(tokens: np.ndarray, parents: np.ndarray,
                          targets: np.ndarray
                          ) -> Tuple[List[int], List[int], int]:
    """Greedy tree acceptance: walk from the root, at each accepted
    node following the child whose token equals that node's greedy
    verify target (``targets[i]`` = argmax of the logits scored at
    node i, i.e. the token plain greedy decode would emit after node
    i's root path). The first node with no matching child contributes
    the target as the BONUS token. Returns ``(path, committed,
    accepted)`` where ``path`` is the node-index root path (starting
    at 0), ``committed`` the ``accepted + 1`` tokens to commit —
    token-identical to plain greedy decode by construction: every
    committed token is the argmax conditioned on exactly the committed
    prefix."""
    tokens = np.asarray(tokens, np.int64).reshape(-1)
    parents = np.asarray(parents, np.int64).reshape(-1)
    targets = np.asarray(targets, np.int64).reshape(-1)
    children: List[List[int]] = [[] for _ in range(tokens.size)]
    for i in range(1, parents.size):
        children[int(parents[i])].append(i)
    v, path, committed = 0, [0], []
    while True:
        t = int(targets[v])
        nxt = next((c for c in children[v] if int(tokens[c]) == t), None)
        committed.append(t)
        if nxt is None:
            return path, committed, len(path) - 1
        v = nxt
        path.append(v)


def tree_rejection_sample(tokens: np.ndarray, parents: np.ndarray,
                          logits: np.ndarray, temperature: float,
                          rng: np.random.Generator
                          ) -> Tuple[List[int], List[int], int]:
    """Sampled tree acceptance (multi-draft point-mass rejection):
    walk from the root; at node v with target distribution p =
    softmax(logits[v] / T), try v's children IN ORDER — child c with
    token x is accepted with probability p_cur(x); on rejection x is
    zeroed out of p_cur and the remainder renormalized (the point-mass
    residual, exactly :func:`rejection_sample_tokens` with q = a point
    mass per sibling). If no child accepts, the corrective token
    samples the final residual; if the walk reaches a leaf, the bonus
    token samples that leaf's own target distribution. Sequentially
    peeling point masses this way keeps the committed-token law EXACTLY
    plain sampled decode regardless of how the tree was proposed (the
    JAX package's distribution gate). The draft model's
    real q sharpens acceptance only on the LINEAR path, where each
    position has a single draft drawn from q.

    ``temperature == 0`` degenerates to :func:`longest_accepted_path`.
    Returns ``(path, committed, accepted)`` like the greedy walk."""
    tokens = np.asarray(tokens, np.int64).reshape(-1)
    parents = np.asarray(parents, np.int64).reshape(-1)
    logits = np.asarray(logits, np.float64)
    if temperature == 0.0:
        return longest_accepted_path(
            tokens, parents, np.argmax(logits, axis=-1))
    children: List[List[int]] = [[] for _ in range(tokens.size)]
    for i in range(1, parents.size):
        children[int(parents[i])].append(i)
    v, path, committed = 0, [0], []
    while True:
        p = _softmax(logits[v] / temperature)
        nxt = None
        for c in children[v]:
            x = int(tokens[c])
            if rng.random() < p[x]:
                nxt = c
                break
            p[x] = 0.0
            s = p.sum()
            if s <= 0.0:
                # residual emptied by float fuzz: p was (numerically) a
                # point mass on the rejected siblings — acceptance was
                # certain in exact arithmetic, take this child
                nxt = c
                break
            p = p / s
        if nxt is None:
            # all children rejected (or leaf): corrective/bonus token
            # from the current (residual) distribution
            committed.append(int(rng.choice(p.size, p=p)))
            return path, committed, len(path) - 1
        committed.append(int(tokens[nxt]))
        v = nxt
        path.append(v)
