"""The span recorder (`utils/spans.py`) on `lm.train_step`.

A 2-layer GQA `TransformerLM` (and its MHA twin) on the CPU, where the
recorder reads the host clock. Off, the step records nothing and adds no
autograd node; on, it counts every region a step, its backward brackets
never interleave, the spans partition the step, and loss and gradients
are bitwise those of the step off; a `torch.profiler` profile turns it
on by itself; under a `torch.func` transform it passes through. One
test, marked `cuda`, runs the recorder's CUDA events on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py -q
"""

import contextlib
import copy
import json

import pytest
import torch

from pytorch_distributed_example_tpu_torch.examples import lm
from pytorch_distributed_example_tpu_torch.models import TransformerConfig, TransformerLM
from pytorch_distributed_example_tpu_torch.utils import spans

L_ = 2  # layers
LEAVES = ("embed", "norm", "cast", "gemm", "rope", "gqa_copy", "attention", "swiglu", "loss")
MARKS = {"_InMarkBackward", "_OutMarkBackward"}


def _model(kv_heads=2, remat=False, device="cpu"):
    """In bf16 compute, as the port trains on the card: every region's
    float32 work then starts with a cast, so each input's gradient sums in
    the same order with the marks as without. (In float32, RMSNorm's `x * x`
    reads its input twice, and the marks sum those gradients before the
    residual's rather than after, which moves the last bit.)"""
    cfg = TransformerConfig(vocab_size=64, d_model=64, n_layers=L_, n_heads=4,
                            n_kv_heads=kv_heads, max_seq_len=32, remat=remat,
                            dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    return TransformerLM(cfg, device=device, generator=gen)


def _tokens(device="cpu"):
    return torch.randint(0, 64, (2, 32), generator=torch.Generator().manual_seed(1)).to(device)


def _calls_a_step(gqa: bool) -> dict:
    return {"embed": 1, "norm": 2 * L_ + 1, "cast": 7 * L_ + 1, "gemm": 7 * L_ + 1,
            "rope": 2 * L_, "gqa_copy": L_ if gqa else 0, "attention": L_, "swiglu": L_,
            "loss": 2}


def _graph_names(t) -> set:
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    yield
    spans.reset()


def _step_pair(on_a, on_b, **kw):
    """Two copies of one model, one train step each on the same tokens, the
    first with the recorder `on_a`, the second `on_b`: (losses, models)."""
    a = _model(**kw)
    b = copy.deepcopy(a)
    out = []
    for m, on in ((a, on_a), (b, on_b)):
        opt = lm.make_optimizer(m, 1e-3)
        with spans.recording() if on else contextlib.nullcontext():
            out.append(lm.train_step(m, opt, _tokens()))
    return out, (a, b)


def _assert_bitwise(losses, models):
    assert torch.equal(losses[0], losses[1])
    for (n, p), q in zip(models[0].named_parameters(), models[1].parameters()):
        assert torch.equal(p.grad, q.grad), n
        assert torch.equal(p, q), n


def test_off_records_nothing_and_adds_no_node(monkeypatch):
    assert not spans.enabled()

    def refuse(*a, **k):
        raise AssertionError("the recorder recorded while off")

    monkeypatch.setattr(spans._REC, "open", refuse)
    monkeypatch.setattr(spans._REC, "close", refuse)
    monkeypatch.setattr(spans, "record_function", refuse)
    monkeypatch.setattr(spans._InMark, "apply", refuse)
    monkeypatch.setattr(spans._OutMark, "apply", refuse)
    m = _model()
    lm.train_step(m, lm.make_optimizer(m, 1e-3), _tokens())
    assert not MARKS & _graph_names(lm.loss_fn(m(_tokens()), _tokens()))
    assert spans.summary() == {"steps": 0, "spans": {}}


def test_on_marks_the_graph():
    m = _model()
    with spans.recording():
        assert spans.enabled()
        names = _graph_names(lm.loss_fn(m(_tokens()), _tokens()))
    assert MARKS <= names
    assert not spans.enabled()


@pytest.mark.parametrize("remat", [False, True])
def test_on_is_bitwise_the_step_off(remat):
    losses, models = _step_pair(False, True, remat=remat)
    _assert_bitwise(losses, models)
    # and the step after, from the updated weights
    for m, on in zip(models, (False, True)):
        with spans.recording() if on else contextlib.nullcontext():
            losses.append(lm.train_step(m, lm.make_optimizer(m, 1e-3), _tokens()))
    _assert_bitwise(losses[2:], models)


@pytest.mark.parametrize("kv_heads", [2, 4], ids=["gqa", "mha"])
def test_every_region_counted_a_step(kv_heads):
    m = _model(kv_heads)
    opt = lm.make_optimizer(m, 1e-3)
    steps = 2
    with spans.recording():
        for _ in range(steps):
            lm.train_step(m, opt, _tokens())
    s = spans.summary()
    assert s["steps"] == steps
    got = s["spans"]
    for name, calls in _calls_a_step(kv_heads < 4).items():
        if calls == 0:
            assert f"tdx.{name}" not in got
            continue
        r = got[f"tdx.{name}"]
        assert r["calls"] == steps * calls, name
        assert r["forward_ms"] > 0 and r["backward_ms"] > 0, name
        # a leaf holds no span: its own time is all its time
        assert r["forward_ms"] + r["backward_ms"] == pytest.approx(r["inclusive_ms"]), name
    for phase, calls in (("step", 1), ("forward", 1), ("backward", 1), ("optimizer", 2)):
        assert got[f"tdx.{phase}"]["calls"] == steps * calls
        assert got[f"tdx.{phase}"]["backward_ms"] == 0
    # every stretch of a step is charged to exactly one span
    own = sum(r["forward_ms"] + r["backward_ms"] for r in got.values())
    assert own == pytest.approx(got["tdx.step"]["inclusive_ms"], rel=1e-9)
    parts = sum(got[f"tdx.{p}"]["inclusive_ms"] for p in ("forward", "backward", "optimizer"))
    assert parts <= got["tdx.step"]["inclusive_ms"]
    assert all(not st.stack for st in spans._REC.streams.values())


@pytest.mark.parametrize("remat", [False, True])
def test_backward_brackets_never_interleave(monkeypatch, remat):
    log = []
    opened, closed = spans._REC.open, spans._REC.close

    def open_(device, name, direction):
        entry = opened(device, name, direction)
        log.append(("open", entry))
        return entry

    def close(device, entry):
        log.append(("close", entry))
        closed(device, entry)

    monkeypatch.setattr(spans._REC, "open", open_)
    monkeypatch.setattr(spans._REC, "close", close)
    m = _model(remat=remat)
    with spans.recording():
        lm.train_step(m, lm.make_optimizer(m, 1e-3), _tokens())
    back = [(what, e) for what, e in log if e.direction == spans.BACKWARD]
    assert back and len(back) % 2 == 0
    for (w0, a), (w1, b) in zip(back[::2], back[1::2]):
        assert (w0, w1) == ("open", "close") and a is b
    # in the reverse of the forward's order (every region here takes a
    # gradient); under remat the recompute re-enters the forwards
    names = [e.name for what, e in log if what == "open" and e.direction == spans.FORWARD
             and e.name in LEAVES]
    if not remat:
        assert [e.name for _, e in back[::2]] == names[::-1]


def test_profiler_turns_it_on(tmp_path):
    m = _model()
    opt = lm.make_optimizer(m, 1e-3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert spans.enabled()
        lm.train_step(m, opt, _tokens())
    assert not spans.enabled()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        ranges = {e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"}
    for p in ("step", "forward", "backward", "optimizer"):
        assert f"tdx.{p}" in ranges
    for name in LEAVES:
        assert {f"tdx.{name}", f"tdx.{name}.backward"} <= ranges, name
    assert spans.summary()["steps"] == 1


def test_passes_through_a_func_transform():
    m = _model()
    params = {k: v.detach() for k, v in m.named_parameters()}
    tokens = _tokens()

    def loss(p):
        return lm.loss_fn(torch.func.functional_call(m, p, (tokens,)), tokens)

    want = torch.func.grad(loss)(params)
    with spans.recording():
        got = torch.func.grad(loss)(params)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert spans.summary()["spans"] == {}


@pytest.mark.cuda
def test_cuda_events_partition_the_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    dev = torch.device("cuda", 0)
    m = _model(device=dev)
    opt = lm.make_optimizer(m, 1e-3)
    lm.train_step(m, opt, _tokens(dev))  # warm up
    spans.reset()
    with spans.recording():
        for _ in range(3):
            lm.train_step(m, opt, _tokens(dev))
    s = spans.summary()
    assert s["steps"] == 3
    got = s["spans"]
    for name, calls in _calls_a_step(True).items():
        assert got[f"tdx.{name}"]["calls"] == 3 * calls, name
        assert got[f"tdx.{name}"]["backward_ms"] > 0, name
    own = sum(r["forward_ms"] + r["backward_ms"] for r in got.values())
    assert own == pytest.approx(got["tdx.step"]["inclusive_ms"], rel=1e-3)
    assert all(not st.stack and len(st.marks) <= 1 for st in spans._REC.streams.values())
