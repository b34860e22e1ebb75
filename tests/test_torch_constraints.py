"""Grammar-constrained decoding: the port against the JAX package.

- **Compilers**: ``dfa_from_sequences``, ``dfa_from_regex`` (classes,
  negated classes, ``|``, ``*`` ``+`` ``?``, escapes, ``.``) and
  ``json_schema_dfa`` (regex metacharacters in keys and enum values)
  over ``chip_smoke.synthetic_vocab``'s token strings: the port's
  ``next``, ``accepting``, ``start``, ``content_hash`` and ``to_record``
  equal the reference's, and a record of either loads in the other.
- **``ConstraintState`` walks**: on the same seeded walks (eos and
  eos-less, through dead ends), ``mask()`` arrays, states and counters
  are equal at every step, and both refuse an inadmissible token.
- **The engine** against ``paddle_tpu.inference.
  ContinuousBatchingEngine(constraints=True)``, greedy, on the tiny f32
  Llama of ``tests/test_torch_scheduler.py``: a mixed batch of trie,
  regex, JSON and free requests (queued behind two slots; one ends on
  its first token), the same with
  KV int8 and with ``fused=True``, a multi-chunk prefill
  (``prefill_chunk=8``), and an eos-less engine whose grammar completes.
  Per request: tokens, ``finish_reason``, and the constraint's
  ``state``, ``finished``, ``tokens_masked_total`` and ``dead_ends``.
- **The scheduler**: both sides' ``ServingScheduler``, synchronous and
  ``overlap=True``, with a HIGH burst that preempts a constrained LOW
  request mid-grammar; the same fields plus preemption and resume
  counts and every step's plan (``test_torch_scheduler``'s ``_Run``).
- **The port alone**: sampled decoding (``temperature=0.9``) emits only
  grammar-valid tokens; a full-vocab DFA and a grammar of the free run's
  own output are token-identical to the free run; an overlapped decode
  dispatch uploads the mask of the current DFA states, and only after a
  change; the refusals (``spec_k``, a constraint or an
  ``attach_constraint`` without ``constraints=True``).

Two JAX engines of one program signature share their compiled programs
(``_engine``), as ``tests/test_adapters.py`` does.
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_scheduler as ts
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the synthetic table, schema and walk)
from paddle_tpu import serving as jserving  # noqa: E402
from paddle_tpu_torch import serving as tserving  # noqa: E402

torch.set_num_threads(1)
VOCAB = 256
EOS = 2
TOKS = chip_smoke.synthetic_vocab(VOCAB, seed=5)
MODS = {"jax": jserving, "port": tserving}
SCHEMA = chip_smoke.TOOL_SCHEMA
META_SCHEMA = {"type": "object", "properties": {
    "a.b": {"enum": ["x+y", "(z)", "[w]"]},
    "c|d*": {"type": "integer"}, "e?": {"type": "boolean"}}}
PATTERNS = ["[a-z]+(,[a-z]+)*", "a(b|c)*", "(x|yz)?q+", r"\(a\.b\)\*",
            ".b", "[^a-c]+", "(0|-?[1-9][0-9]*)", r"\{[A-Z_]*\}"]


def _compile(mod, kind, arg):
    if kind == "seq":
        return mod.dfa_from_sequences(arg, VOCAB)
    if kind == "regex":
        return mod.dfa_from_regex(arg, TOKS)
    return mod.json_schema_dfa(arg, TOKS)


def _menu(seed, n=6):
    rs = np.random.RandomState(seed)
    return [rs.randint(3, VOCAB, (int(rs.randint(2, 6)),)).tolist()
            for _ in range(n)]


COMPILER_CASES = ([("seq", _menu(1)), ("seq", [[4, 5], [4, 5, 6], []])]
                  + [("regex", p) for p in PATTERNS]
                  + [("json", SCHEMA), ("json", META_SCHEMA)])


@pytest.mark.parametrize("kind,arg", COMPILER_CASES,
                         ids=[f"{k}{i}" for i, (k, _) in
                              enumerate(COMPILER_CASES)])
def test_compilers_match_jax(kind, arg):
    ref, got = (_compile(MODS[s], kind, arg) for s in ("jax", "port"))
    np.testing.assert_array_equal(got.next, ref.next)
    np.testing.assert_array_equal(got.accepting, ref.accepting)
    assert got.start == ref.start
    assert got.content_hash() == ref.content_hash()
    assert got.to_record() == ref.to_record()
    assert (got.next >= 0).any()
    back = tserving.TokenDFA.from_record(ref.to_record())
    assert back.content_hash() == ref.content_hash()
    there = jserving.TokenDFA.from_record(got.to_record())
    np.testing.assert_array_equal(there.next, ref.next)


def test_regex_errors_match_jax():
    for bad in ("(ab", "[ab", "a)"):
        msgs = []
        for side in ("jax", "port"):
            with pytest.raises(ValueError) as e:
                MODS[side].dfa_from_regex(bad, TOKS)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="object"):
        tserving.json_schema_dfa({"type": "array"}, TOKS)
    with pytest.raises(ValueError, match="outside vocab"):
        tserving.dfa_from_sequences([[VOCAB]], VOCAB)


def _dead_end_dfa(mod):
    """0 -4-> 1 (accepting, live) -5-> 2 (dead end: not accepting, no
    live transition); 0 -6-> 3 (accepting leaf)."""
    table = np.full((4, 16), -1, np.int32)
    table[0, 4], table[1, 5], table[0, 6] = 1, 2, 3
    return mod.TokenDFA(table, [False, True, False, True])


@pytest.mark.parametrize("eos", [EOS, None], ids=["eos", "eosless"])
@pytest.mark.parametrize("grammar", ["dead_end", "regex", "json"])
def test_constraint_state_walks_match_jax(grammar, eos):
    """The same seeded walks through both packages' states: ``mask()``
    (which counts) at every step, then a random admitted token."""
    rs = np.random.RandomState(len(grammar) + (eos or 0))
    dfas = {s: (_dead_end_dfa(m) if grammar == "dead_end" else
                _compile(m, grammar,
                         SCHEMA if grammar == "json" else PATTERNS[0]))
            for s, m in MODS.items()}
    vocab = dfas["jax"].vocab
    for _ in range(6):
        st = {s: MODS[s].ConstraintState(dfas[s], eos_token_id=eos)
              for s in MODS}
        for _ in range(12):
            m = {s: st[s].mask(vocab) for s in MODS}
            np.testing.assert_array_equal(m["port"], m["jax"])
            tok = int(rs.choice(np.flatnonzero(m["jax"])))
            for s in MODS:
                st[s].advance(tok)
            assert st["port"].state_record() == st["jax"].state_record()
            if st["jax"].finished and rs.rand() < 0.5:
                break
        rec = st["port"].to_record()
        assert rec == st["jax"].to_record()
        assert (tserving.ConstraintState.from_record(rec).state_record()
                == st["jax"].state_record())
    dead = {s: MODS[s].ConstraintState(_dead_end_dfa(MODS[s]),
                                       eos_token_id=EOS) for s in MODS}
    for s in MODS:
        dead[s].advance(4)
        dead[s].advance(5)
        assert dead[s].mask(16).sum() == 1 and dead[s].dead_ends == 1
        with pytest.raises(ValueError, match="inadmissible"):
            dead[s].advance(7)


def test_records_with_a_shared_grammar_table():
    dfa = _compile(tserving, "regex", PATTERNS[1])
    grammars = {}
    rec = tserving.ConstraintState(dfa, eos_token_id=EOS).to_record(grammars)
    assert set(rec) >= {"dfa_hash"} and list(grammars) == [dfa.content_hash()]
    back = jserving.ConstraintState.from_record(rec, grammars)
    assert back.dfa.content_hash() == dfa.content_hash()
    with pytest.raises(ValueError, match="not in the supplied"):
        tserving.ConstraintState.from_record(rec, {})


# ---------------------------------------------------------------- engines

def _engine(side, **kw):
    """One side's engine on ``test_torch_scheduler``'s tiny Llama; JAX
    engines of one program signature share their compiled programs."""
    Engine, _, _, params, cfg, extra = ts._models()[side]
    kw = dict(ts.ENGINE_KW, **kw)
    eng = Engine(params, cfg, **kw, **extra)
    if side == "jax":
        ts._share_programs(eng)
    return eng


def _grammars(side):
    mod = MODS[side]
    return {"menu": mod.dfa_from_sequences(_menu(3), VOCAB),
            "regex": mod.dfa_from_regex(PATTERNS[0], TOKS),
            "json": mod.json_schema_dfa(SCHEMA, TOKS), "free": None}


def _record(reqs):
    out = []
    for r in reqs:
        c = r.constraint
        out.append(dict(
            tokens=list(map(int, r.tokens)), reason=str(r.finish_reason),
            done=r.done,
            constraint=None if c is None else (
                int(c.state), bool(c.finished), int(c.tokens_masked_total),
                int(c.dead_ends))))
    return out


def _walks(reqs, grammars, kinds, eos=EOS):
    """Every constrained request's tokens walk its DFA; eos only from an
    accepting, dead-end or finished state (``chip_smoke.walk``)."""
    for r, k in zip(reqs, kinds):
        if grammars[k] is not None:
            chip_smoke.walk(grammars[k], r.tokens, eos)


def _serve_engine(side, specs, engine_kw, eos=EOS):
    """Submit ``specs`` (grammar kind, prompt, new) to one engine and run
    it to the end."""
    g = _grammars(side)
    eng = _engine(side, constraints=True, eos_token_id=eos, **engine_kw)
    reqs = [eng.submit(p, max_new_tokens=n, constraint=g[k])
            for k, p, n in specs]
    eng.run()
    return eng, reqs, g


def _mixed():
    a, b, c, d, e, f = ts._prompts((5, 11, 3, 9, 7, 6), seed=31)
    return [("menu", a, 8), ("regex", b, 10), ("free", c, 6),
            ("json", d, 12), ("regex", e, 5), ("json", f, 1)]


def _chunked():
    a, b, c = ts._prompts((21, 18, 6), seed=32)
    return [("json", a, 10), ("regex", b, 8), ("menu", c, 6)]


def _eosless():
    a, b, c = ts._prompts((6, 8, 4), seed=33)
    return [("menu", a, 9), ("regex", b, 7), ("free", c, 5)]


ENGINE_CASES = {
    "mixed": (_mixed, {}, EOS),
    "int8": (_mixed, {"kv_cache_dtype": "int8"}, EOS),
    "fused": (_mixed, {"fused": True}, EOS),
    "chunked": (_chunked, {"prefill_chunk": 8}, EOS),
    "eosless": (_eosless, {}, None),
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_matches_jax(name):
    specs, kw, eos = ENGINE_CASES[name]
    runs = {s: _serve_engine(s, specs(), kw, eos) for s in MODS}
    want, got = (_record(runs[s][1]) for s in ("jax", "port"))
    assert got == want
    eng, reqs, g = runs["port"]
    assert all(r.done for r in reqs)
    _walks(reqs, g, [k for k, _, _ in specs()], eos)
    ts._assert_balanced(eng)
    assert eng._cmask.all()               # every slot cleared
    if name == "eosless":
        menu = reqs[0].constraint
        assert menu.finished and menu.dead_ends == 0
    else:
        assert any(r.finish_reason == "eos" for r in reqs)


def _sched(side, overlap):
    """A NORMAL free request and a LOW JSON one, then a HIGH regex burst
    after 5 steps that preempts the LOW one mid-grammar."""
    g = _grammars(side)
    run = ts._Run(side, budget=20, overlap=overlap, constraints=True,
                  eos_token_id=EOS)
    a, b, c = ts._prompts((5, 11, 3), seed=3)
    run.submit(a, 8, "NORMAL")
    low = run.submit(b, 14, "LOW", constraint=g["json"])
    run.step(5)
    assert low.tokens and not low.done   # mid-grammar at the burst
    run.submit(c, 6, "HIGH", constraint=g["regex"])
    run.drain()
    return run, g


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_scheduler_preempts_constrained_request_like_jax(overlap):
    runs = {s: _sched(s, overlap) for s in MODS}
    (jrun, _), (run, g) = runs["jax"], runs["port"]
    assert _record(run.reqs) == _record(jrun.reqs)
    assert run.record() == jrun.record()
    assert run.sched.preemptions_total == 1 == run.sched.resumes_total
    assert run.reqs[1].preemptions == 1
    _walks(run.reqs, g, ["free", "json", "regex"])
    ts._assert_balanced(run.eng)


# --------------------------------------------------------------- the port

def test_sampled_constrained_tokens_walk_the_grammar():
    specs = _mixed()
    eng, reqs, g = _serve_engine(
        "port", specs, {"temperature": 0.9,
                        "generator": torch.Generator().manual_seed(3)})
    assert all(r.done for r in reqs)
    _walks(reqs, g, [k for k, _, _ in specs])
    ts._assert_balanced(eng)


def test_masking_only_excludes():
    """A full-vocab DFA, and a grammar of each request's own free-run
    output, leave greedy decode token-identical to the free run, on the
    engine and under the overlapped scheduler."""
    prompts = ts._prompts((5, 11, 3, 9), seed=34)
    free = _engine("port", eos_token_id=EOS)
    handles = [free.submit(p, max_new_tokens=7) for p in prompts]
    free.run()
    want = [list(map(int, r.tokens)) for r in handles]
    full = tserving.TokenDFA(np.zeros((1, VOCAB), np.int32), [True])
    for grammar in ("full", "own"):
        eng = _engine("port", constraints=True, eos_token_id=EOS)
        sched = tserving.ServingScheduler(eng, overlap=True)
        reqs = [sched.submit(p, max_new_tokens=7, constraint=(
            full if grammar == "full" else
            tserving.dfa_from_sequences([w], VOCAB)))
            for p, w in zip(prompts, want)]
        sched.run()
        assert [list(map(int, r.tokens)) for r in reqs] == want, grammar


def test_overlapped_dispatch_uploads_the_current_mask():
    """Each overlapped decode dispatch samples under the mask of every
    seated request's DFA state as the last commit left it, and uploads
    the mask only after a host-side change."""
    eng = _engine("port", constraints=True, eos_token_id=EOS, overlap=True)
    sched = tserving.ServingScheduler(eng, token_budget=20)
    g = _grammars("port")
    kinds = ["json", "regex", "free", "menu"]
    reqs = [sched.submit(p, max_new_tokens=9, constraint=g[k])
            for k, p in zip(kinds, ts._prompts((5, 11, 3, 9), seed=35))]
    seen = []
    dispatch = eng.decode_dispatch

    def checked(mask):
        want = np.ones_like(eng._cmask)
        for s, r in enumerate(eng._slots):
            if r is not None and r.constraint is not None:
                want[s] = copy.deepcopy(r.constraint).mask(VOCAB)
        h = dispatch(mask)
        np.testing.assert_array_equal(eng._cmask_dev.numpy(), want)
        seen.append(eng.cmask_uploads)
        return h

    eng.decode_dispatch = checked
    sched.run()
    assert all(r.done for r in reqs) and len(seen) > 4
    _walks(reqs, g, kinds)
    # free requests alone: uploads at seatings and clears, not per step
    eng = _engine("port", constraints=True, eos_token_id=EOS)
    sched = tserving.ServingScheduler(eng)
    for p in ts._prompts((5, 6), seed=36):
        sched.submit(p, max_new_tokens=12)
    sched.run()
    assert 0 < eng.cmask_uploads < eng.forwards["decode"]


def test_refusals():
    Engine, Sched, _, params, cfg, extra = ts._models()["port"]
    kw = dict(ts.ENGINE_KW, **extra)
    with pytest.raises(ValueError, match="constraints"):
        Engine(params, cfg, spec_k=2, constraints=True, **kw)
    with pytest.raises(ValueError, match="constraints"):
        Engine(params, cfg, draft_layers=1, spec_tree=(2, 2),
               constraints=True, **kw)
    eng = Engine(params, cfg, **kw)
    dfa = tserving.dfa_from_sequences([[4]], VOCAB)
    p = ts._prompts((4,), seed=1)[0]
    with pytest.raises(ValueError, match="constraints=True"):
        eng.submit(p, max_new_tokens=2, constraint=dfa)
    with pytest.raises(ValueError, match="constraints=True"):
        Sched(eng).submit(p, max_new_tokens=2, constraint=dfa)
    req = eng.create_request(p, max_new_tokens=2)
    assert eng.attach_constraint(req, None) is req
    with pytest.raises(ValueError, match="constraints=True"):
        eng.attach_constraint(req, tserving.ConstraintState(dfa))
    for bad, step in (({"adapters": {"mesh": object()}}, "step 7"),
                      ({"mesh": object()}, "1.9")):
        with pytest.raises(NotImplementedError, match=step):
            Engine(params, cfg, **bad, **kw)
    ok = Engine(params, cfg, constraints=True, **kw)
    st = tserving.ConstraintState(dfa, eos_token_id=EOS)
    assert ok.attach_constraint(req, st).constraint is st
    r = ok.submit(p, max_new_tokens=2, constraint=dfa)
    assert isinstance(r.constraint, tserving.ConstraintState)
    assert r.constraint.eos_token_id is None     # the engine's own eos
