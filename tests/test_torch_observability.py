"""The port's observability layer against the JAX package's, on the CPU.

- the metrics registry, the request tracer and the flight recorder
  (``paddle_tpu_torch/observability``): one sequence of calls on both
  packages gives the same Prometheus exposition, JSON snapshot, Chrome
  trace and trace tails, and each package reads the other's flight
  dump;
- counter parity: the JAX engine and ``ServingScheduler`` and the
  port's, with metrics and request tracing on and each registry
  cleared, run ``test_torch_scheduler``'s ``preempt`` workload (a HIGH
  burst preempts a LOW request, which resumes by replay), its n-gram
  workload, and ``test_torch_constraints``' preemption of a constrained
  request. Every counter's value, by name and labels, and every
  histogram's sample count must be equal (times are not compared), and
  so must each request's trace as a list of (span, slot, seq);
- dense ``generate``'s prefill and decode phases count the same tokens
  as JAX's;
- with the hooks off the port's registry stays empty, no request
  carries a trace, and no hook waits for the card; with them on, every
  wait (``hooks._block``) comes from a commit half or ``generate``,
  never from a dispatch.

The tiny f32 Llama and engine geometry are ``test_torch_scheduler``'s;
an overlapped JAX engine there steps with a copying ``jnp.asarray``.
"""
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu.observability as jobs
from paddle_tpu.models import generate as jgen
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import tracing as jtracing
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.models import generate as tgen
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import tracing as ttracing

import test_torch_scheduler as ts
sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_constraints as tc  # noqa: E402

torch.set_num_threads(1)
OBS = {"jax": (jobs, jtracing), "port": (tobs, ttracing)}


class _Clock:
    """A virtual nanosecond clock: each reading advances by 1000."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 1000
        return self.t


@pytest.fixture
def sinks():
    """Metrics and request tracing on for both packages, registries
    cleared; everything off and cleared again afterwards. ``enable``
    replaces a package's ``TRACER`` and ``disable`` only clears the
    flag, so the tracers found here are put back: a later test in the
    same process that reads ``tracing.TRACER`` sees no span of these."""
    saved = {side: tr.TRACER for side, (_, tr) in OBS.items()}
    for obs, tr in OBS.values():
        obs.REGISTRY.clear()
        obs.enable()
        tr.enable(clock_ns=_Clock())
    yield
    for side, (obs, tr) in OBS.items():
        obs.disable()
        tr.disable()
        tr.TRACER = saved[side]
        obs.REGISTRY.clear()


def _script(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("reqs_total", "requests", ("route", "code"))
    c.labels("/a", 200).inc()
    c.labels(route="/b", code="500").inc(2.5)
    reg.counter("plain_total", "no labels").inc(3)
    g = reg.gauge("depth", "queue depth", ("prio",))
    g.labels(0).set(4)
    g.labels(1).inc(2)
    g.labels(1).dec(0.5)
    h = reg.histogram("lat_ms", "latency", ("k",), buckets=(1, 5, 10))
    for v in (0.5, 3, 7, 12, 5):
        h.labels('q"x\\').observe(v)
    reg.histogram("dflt_seconds", "default buckets").observe(0.003)
    with pytest.raises(ValueError):
        reg.gauge("reqs_total")
    with pytest.raises(ValueError):
        reg.histogram("lat_ms", buckets=(2, 3))
    with pytest.raises(ValueError):
        c.inc()
    return reg


class _Req:
    def __init__(self, rid):
        self.rid = rid
        self.tokens = []
        self.trace = None


def _trace_script(tr):
    t = tr.Tracer(max_traces=3, max_spans=6, clock_ns=_Clock())
    reqs = [_Req(i) for i in range(4)]
    for r in reqs:
        t.attach(r, replica=0)
    a, b = reqs[1], reqs[2]
    t.enqueued(a)
    t.admitted(a, replica=0, slot=1, meta={"shared": 8})
    a0 = t.now()
    t.record(a, "prefill_chunk", a0, replica=0, slot=1, seq=0,
             meta={"take": 8})
    a.tokens.append(5)
    t.first_token(a)
    for i in range(5):
        d0 = t.now()
        t.record(a, "decode_step", d0, replica=0, slot=1, seq=i + 1)
    t.mark(b, "preempt", replica=0, slot=0, meta={"swap": False})
    t.admitted(b, slot=0)
    t.finish(a, "max_len", replica=0)
    t.finish(a, "max_len")                 # idempotent
    t.attach(a)                            # keeps its trace
    return t


def test_registry_tracer_and_flight_match_jax(tmp_path):
    regs = {s: _script(OBS[s][0]) for s in OBS}
    assert regs["port"].to_prometheus() == regs["jax"].to_prometheus()
    assert regs["port"].to_json() == regs["jax"].to_json()
    assert regs["port"].names() == regs["jax"].names()
    trs = {s: _trace_script(OBS[s][1]) for s in OBS}
    assert trs["port"].chrome() == trs["jax"].chrome()
    assert trs["port"].tails(8, 4) == trs["jax"].tails(8, 4)
    assert trs["port"].breakdowns() == trs["jax"].breakdowns()
    assert trs["port"].stats() == trs["jax"].stats()
    assert trs["port"].stats()["evicted"] == 1
    # a dump of one package loads in the other's loader, and a torn
    # dump fails both
    rec = tflight.FlightRecorder(max_ticks=2, meta={"replica": 3})
    for i in range(3):
        rec.record_tick(step=np.int64(i), budget=None, fault=None)
    path = rec.dump(str(tmp_path), "manual", extra={"x": 1})
    assert jflight.load(path) == tflight.load(path)
    assert tflight.load(path)["ticks"] == [
        {"step": 1, "budget": None, "fault": None},
        {"step": 2, "budget": None, "fault": None}]
    assert tflight.find_dumps(str(tmp_path)) == [path]
    jpath = jflight.FlightRecorder().dump(str(tmp_path / "j"), "x")
    assert tflight.load(jpath)["reason"] == "x"
    raw = open(path, "rb").read().replace(b'"manual"', b'"manuaL"')
    open(path, "wb").write(raw)
    for mod in (tflight, jflight):
        with pytest.raises(ValueError, match="CRC"):
            mod.load(path)


def _counters(obs):
    """{(name, labels): value} of every counter, and the sample count
    of every histogram child."""
    out = {}
    for name, m in obs.REGISTRY.to_json().items():
        for labels, v in m["values"].items():
            if m["kind"] == "counter":
                out[(name, labels)] = v
            elif m["kind"] == "histogram":
                out[(name, labels, "count")] = v["count"]
    return out


def _traces(reqs):
    return [[(s.name, s.slot, s.seq) for s in r.trace.spans] for r in reqs]


PARITY = {
    "preempt": lambda side: ts.WORKLOADS["preempt"](side).reqs,
    "preempt_overlap": lambda side: ts.WORKLOADS["preempt_overlap"](
        side).reqs,
    "ngram": lambda side: ts.WORKLOADS["ngram"](side).reqs,
    "constrained": lambda side: tc._sched(side, False)[0].reqs,
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_counters_and_traces_match_jax(sinks, name):
    got = {}
    for side in ("jax", "port"):
        obs, tr = OBS[side]
        obs.REGISTRY.clear()
        tr.enable(clock_ns=_Clock())
        reqs = PARITY[name](side)
        got[side] = (_counters(obs), _traces(reqs))
    (jc, jt), (pc, pt) = got["jax"], got["port"]
    assert pc == jc
    assert pt == jt
    # what the workload is there for happened
    assert pc[("serving_preemptions_total", "")] == 1
    assert pc[("serving_resumes_total", "")] == 1
    adm = pc[("serving_admissions_total", "")]
    ev = sum(v for k, v in pc.items() if k[0] == "serving_evictions_total")
    assert adm == ev == len(pt)
    if name == "ngram":
        assert pc[("serving_spec_accepted_tokens_total", "")] > 0
    if name == "constrained":
        assert pc[("serving_constrain_rows_total", "")] > 0
    assert any(n == "resume_replay" for n, _, _ in sum(pt, []))


def test_generate_phases_match_jax(sinks):
    _, _, _, jp, jcfg, _ = ts._models()["jax"]
    _, _, _, tp, tcfg, _ = ts._models()["port"]
    prompt = np.asarray(ts._prompts((6, 6), seed=21))
    jgen.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=4)
    tgen.generate(tp, prompt, tcfg, max_new_tokens=4)
    jc, pc = _counters(jobs), _counters(tobs)
    assert pc == jc
    assert pc[("generate_tokens_total", "phase=prefill")] == 12
    assert pc[("generate_tokens_total", "phase=decode")] == 8


def _port_fused_run():
    run = ts._Run("port", budget=20, overlap=True, fused=True,
                  prefill_chunk=8)
    a, b, c = ts._prompts((5, 11, 3), seed=3)
    run.submit(a, 6, "NORMAL")
    run.submit(b, 6, "LOW")
    run.step(5)
    run.submit(c, 6, "HIGH")
    run.drain()
    return run


def test_hooks_off_cost_nothing_and_waits_stay_in_commits(monkeypatch):
    """Off: the registry stays empty, no trace is attached, no hook
    waits. On: every wait comes from a commit half (or generate)."""
    hooks = tobs.hooks
    tobs.REGISTRY.clear()
    assert not hooks.enabled and not ttracing.enabled
    callers = []

    def spy(x):
        callers.append(sys._getframe(2).f_code.co_name)
    monkeypatch.setattr(hooks, "_block", spy)
    run = _port_fused_run()
    assert all(r.done for r in run.reqs)
    assert tobs.REGISTRY.names() == [] and callers == []
    assert all(r.trace is None for r in run.reqs)
    hooks.enable()
    try:
        run = _port_fused_run()
    finally:
        hooks.disable()
    assert set(callers) == {"_commit_chunk", "_decode_commit"}
    c = _counters(tobs)
    tobs.REGISTRY.clear()
    assert c[("serving_fused_step_ms", "kernel=decode_rope_attn",
              "count")] > 0
    assert c[("serving_prefill_chunk_ms", "", "count")] > 0
    assert c[("serving_sched_steps_total", "")] == len(run.plans)
