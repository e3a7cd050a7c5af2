"""The port's pipeline schedules against the JAX package's, on the CPU.

Every case of the reference's `tests/test_parallelism.py::TestPipeline`
runs through both packages on the same numpy inputs: the reference under
`shard_map` on the conftest's virtual CPU devices, the port in driver mode
(the S stages stacked on one device), each case at the reference's own
tolerances: forwards rtol 1e-4 / atol 1e-5, losses rtol 1e-5, gradients
rtol 1e-4 / atol 1e-6. The reference's 1F1B memory property (XLA's temp
bytes flat in M) becomes the peak bytes of the storages the schedule
holds (a dispatch mode counting live storages). Last, a pipeline whose stages are one small
transformer `Block` each, flash on (the reference's Pallas kernels in
interpret mode, the port's plain versions), on converted params: under
`vmap` and `torch.func.vjp`, through the flash Function.
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from pytorch_distributed_example_tpu.mesh import init_device_mesh
from pytorch_distributed_example_tpu.models import transformer as jtr
from pytorch_distributed_example_tpu.parallel import pipeline as jpp
from pytorch_distributed_example_tpu_torch.mesh import DeviceMesh
from pytorch_distributed_example_tpu_torch.models import convert, transformer as ttr
from pytorch_distributed_example_tpu_torch.parallel import pipeline as tpp

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _jmesh(S):
    return init_device_mesh(("pp",), (S,), devices=jax.devices()[:S])


def _tmesh(S):
    return DeviceMesh(["cpu"] * S, (S,), ("pp",))


def _weights(seed, n, F):
    gen = np.random.default_rng(seed)
    return gen, [(gen.standard_normal((F, F)) * 0.1).astype(np.float32) for _ in range(n)]


def _stacked(ws):
    return (jpp.stack_stage_params([{"w": jnp.asarray(w)} for w in ws]),
            tpp.stack_stage_params([{"w": torch.tensor(w)} for w in ws]))


def _jstage(p, x):
    return jnp.tanh(x @ p["w"])


def _tstage(p, x):
    return torch.tanh(x @ p["w"])


def _jloss(y, t):
    return ((y - t) ** 2).mean()


def _tloss(y, t):
    return ((y - t) ** 2).mean()


def _sequential(ws, x):
    out = torch.tensor(x)
    for w in ws:
        out = torch.tanh(out @ torch.tensor(w))
    return out


def test_pipeline_matches_sequential():
    S, M, mb, F = 8, 4, 2, 16
    gen, ws = _weights(5, S, F)
    jp, tp = _stacked(ws)
    x = gen.standard_normal((M, mb, F)).astype(np.float32)
    want = jpp.make_pipeline_fn(_jstage, _jmesh(S), axis_name="pp")(jp, jnp.asarray(x))
    got = tpp.make_pipeline_fn(_tstage, _tmesh(S), axis_name="pp")(tp, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), _sequential(ws, x).numpy(), **FWD_TOL)


def test_pipeline_grads_flow():
    S, M, mb, F = 8, 2, 2, 8
    gen, ws = _weights(6, S, F)
    jp, tp = _stacked(ws)
    x = gen.standard_normal((M, mb, F)).astype(np.float32)
    jpipe = jpp.make_pipeline_fn(_jstage, _jmesh(S), axis_name="pp", jit=False)
    want = jax.jit(jax.grad(lambda p: (jpipe(p, jnp.asarray(x)) ** 2).sum()))(jp)
    tp["w"].requires_grad_()
    tpipe = tpp.make_pipeline_fn(_tstage, _tmesh(S), axis_name="pp", jit=False)
    (tpipe(tp, torch.tensor(x)) ** 2).sum().backward()
    gw = tp["w"].grad.numpy()
    assert np.isfinite(gw).all()
    assert (np.abs(gw).reshape(S, -1).sum(axis=1) > 0).all()
    np.testing.assert_allclose(gw, np.asarray(want["w"]), **GRAD_TOL)


def test_microbatch_split_merge():
    x = np.arange(24).reshape(8, 3)
    mb = tpp.split_microbatches(torch.tensor(x), 4)
    assert mb.shape == (4, 2, 3)
    np.testing.assert_array_equal(mb.numpy(), np.asarray(jpp.split_microbatches(x, 4)))
    np.testing.assert_array_equal(tpp.merge_microbatches(mb).numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        tpp.split_microbatches(torch.tensor(x), 3)


def _train_pair(seed, S, M, mb, F, schedule, jschedule=None):
    gen, ws = _weights(seed, S, F)
    jp, tp = _stacked(ws)
    x = gen.standard_normal((M, mb, F)).astype(np.float32)
    tgt = gen.standard_normal((M, mb, F)).astype(np.float32)
    jtrain = jpp.make_pipeline_train_fn(_jstage, _jloss, _jmesh(S),
                                        schedule=jschedule or schedule)
    want = jtrain(jp, jnp.asarray(x), jnp.asarray(tgt))
    ttrain = tpp.make_pipeline_train_fn(_tstage, _tloss, _tmesh(S), schedule=schedule)
    got = ttrain(tp, torch.tensor(x), torch.tensor(tgt))
    return ws, x, tgt, want, got


def test_1f1b_matches_dense_loss_and_grads():
    """1F1B: loss and per-stage grads equal the serial model's, and the
    reference's 1F1B."""
    S = 8
    ws, x, tgt, (wl, wg), (loss, grads) = _train_pair(7, S, 6, 2, 16, "1f1b")
    np.testing.assert_allclose(float(loss), float(wl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(grads["w"].numpy(), np.asarray(wg["w"]), **GRAD_TOL)
    stacked = torch.tensor(np.stack(ws)).requires_grad_()
    out = torch.tensor(x)
    for s in range(S):
        out = torch.tanh(out @ stacked[s])
    dense = torch.stack([_tloss(out[m], torch.tensor(tgt[m])) for m in range(len(x))]).mean()
    dense.backward()
    np.testing.assert_allclose(float(loss), float(dense.detach()), rtol=LOSS_RTOL)
    np.testing.assert_allclose(grads["w"].numpy(), stacked.grad.numpy(), **GRAD_TOL)


def test_gpipe_schedule_matches_1f1b():
    """The two schedules are interchangeable, in both packages."""
    _, _, _, (wl, wg), (l2, g2) = _train_pair(8, 4, 4, 2, 8, "gpipe", "1f1b")
    _, _, _, _, (l1, g1) = _train_pair(8, 4, 4, 2, 8, "1f1b")
    np.testing.assert_allclose(float(l1), float(l2), rtol=LOSS_RTOL)
    np.testing.assert_allclose(g1["w"].numpy(), g2["w"].numpy(), **GRAD_TOL)
    np.testing.assert_allclose(float(l2), float(wl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(g2["w"].numpy(), np.asarray(wg["w"]), **GRAD_TOL)


class _LiveBytes(TorchDispatchMode):
    """The peak bytes of the storages that ops create while the mode is on
    and that are still referenced: each counts from the op that made it
    until its last tensor goes (the CPU's `max_memory_allocated`). The
    storages of `inputs` are not counted."""

    def __init__(self, *inputs):
        super().__init__()
        self.ignore = {t.untyped_storage().data_ptr() for t in inputs}
        self.refs, self.live, self.peak = {}, 0, 0

    def _drop(self, key):
        n, refs = self.refs[key]
        if refs > 1:
            self.refs[key] = (n, refs - 1)
        else:
            del self.refs[key]
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = storage.data_ptr()
            if not key or key in self.ignore:
                continue
            n, refs = self.refs.get(key, (storage.nbytes(), 0))
            if not refs:
                self.live += n
                self.peak = max(self.peak, self.live)
            self.refs[key] = (n, refs + 1)
            weakref.finalize(t, self._drop, key)
        return out


def test_1f1b_activation_memory_constant_in_microbatches():
    """THE 1F1B property: the memory it holds is flat in M (the residual
    ring; each recompute's graph is dropped within its tick), while
    GPipe's grows with M (every microbatch's activations live until the
    backward). `torch.func.vjp` refuses saved-tensor hooks, so the bytes
    are every live storage the schedule made, as the card's allocator
    counts them."""
    S, mb, F = 8, 4, 64
    _, ws = _weights(11, S, F)
    _, tp = _stacked(ws)
    mesh = _tmesh(S)

    def peak_bytes(schedule, M):
        x = torch.zeros((M, mb, F))
        with _LiveBytes(x, *tp.values()) as probe:
            tpp.make_pipeline_train_fn(_tstage, _tloss, mesh, schedule=schedule)(tp, x, x)
        return probe.peak

    assert peak_bytes("1f1b", 32) == peak_bytes("1f1b", 8) > 0
    assert peak_bytes("gpipe", 32) > peak_bytes("gpipe", 8)


def test_interleaved_matches_sequential():
    """virtual_stages=V: 2 ring rounds over 4 devices == 8 serial stages."""
    V, S, M, mb, F = 2, 4, 4, 2, 16
    gen, ws = _weights(9, V * S, F)
    jp, tp = _stacked(ws)
    x = gen.standard_normal((M, mb, F)).astype(np.float32)
    want = jpp.make_pipeline_fn(_jstage, _jmesh(S), axis_name="pp", virtual_stages=V)(
        jp, jnp.asarray(x))
    got = tpp.make_pipeline_fn(_tstage, _tmesh(S), axis_name="pp", virtual_stages=V)(
        tp, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), _sequential(ws, x).numpy(), **FWD_TOL)


def test_interleaved_grads_flow():
    V, S, M, mb, F = 2, 4, 2, 2, 8
    gen, ws = _weights(10, V * S, F)
    jp, tp = _stacked(ws)
    x = gen.standard_normal((M, mb, F)).astype(np.float32)
    jpipe = jpp.make_pipeline_fn(_jstage, _jmesh(S), axis_name="pp", jit=False,
                                 virtual_stages=V)
    want = jax.jit(jax.grad(lambda p: (jpipe(p, jnp.asarray(x)) ** 2).sum()))(jp)
    tp["w"].requires_grad_()
    tpipe = tpp.make_pipeline_fn(_tstage, _tmesh(S), axis_name="pp", jit=False,
                                 virtual_stages=V)
    (tpipe(tp, torch.tensor(x)) ** 2).sum().backward()
    gw = tp["w"].grad.numpy()
    assert np.isfinite(gw).all()
    assert (np.abs(gw).reshape(V * S, -1).sum(axis=1) > 0).all()
    np.testing.assert_allclose(gw, np.asarray(want["w"]), **GRAD_TOL)


def test_stage_count_must_match_the_mesh():
    _, ws = _weights(0, 4, 8)
    _, tp = _stacked(ws)
    with pytest.raises(ValueError, match="pp axis holds 8"):
        tpp.make_pipeline_fn(_tstage, _tmesh(8))(tp, torch.zeros(2, 1, 8))
    with pytest.raises(ValueError, match="schedule"):
        tpp.make_pipeline_train_fn(_tstage, _tloss, _tmesh(4), schedule="zb")


# -- transformer blocks as stages, flash on ----------------------------------

BLOCK_KW = dict(vocab_size=64, d_model=64, n_layers=4, n_heads=4, max_seq_len=32,
                use_flash=True)


def _block_pair():
    """(reference stacked block params, port stacked block params, both
    stage fns, cos/sin length L) for 4 stages of one Block each."""
    jcfg = jtr.TransformerConfig(**BLOCK_KW)
    tcfg = ttr.TransformerConfig(**BLOCK_KW)
    L = BLOCK_KW["max_seq_len"]
    params = jax.jit(jtr.TransformerLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32))["params"]
    jstacked = jpp.stack_stage_params([params[f"layers_{i}"] for i in range(4)])
    sd = convert.from_flax(jax.tree.map(np.asarray, {"params": params}))
    tstacked = tpp.stack_stage_params([
        {k[len(f"layers.{i}."):]: v for k, v in sd.items() if k.startswith(f"layers.{i}.")}
        for i in range(4)])
    jcos, jsin = jtr.rope_freqs(jcfg.head_dim, L, jcfg.rope_theta)
    tcos, tsin = ttr.rope_freqs(tcfg.head_dim, L, tcfg.rope_theta)
    jblock, tblock = jtr.Block(jcfg), ttr.Block(tcfg, device="meta")

    def jstage(p, x):
        return jblock.apply({"params": p}, x, jcos, jsin)

    def tstage(p, x):
        return functional_call(tblock, p, (x, tcos, tsin))

    return jstacked, tstacked, jstage, tstage


def test_transformer_block_stages_match_reference():
    """4 stages of one Block each (flash on) over M 2 microbatches of 1 x
    32 tokens: the GPipe forward, and 1F1B's loss and stage gradients
    (the recompute under `torch.func.vjp` of the vmapped stages), against
    the reference's."""
    jp, tp, jstage, tstage = _block_pair()
    gen = np.random.default_rng(3)
    x = gen.standard_normal((2, 1, 32, 64)).astype(np.float32)
    tgt = gen.standard_normal((2, 1, 32, 64)).astype(np.float32)
    jmesh, tmesh = _jmesh(4), _tmesh(4)
    want = jpp.make_pipeline_fn(jstage, jmesh)(jp, jnp.asarray(x))
    got = tpp.make_pipeline_fn(tstage, tmesh)(tp, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    wl, wg = jpp.make_pipeline_train_fn(jstage, _jloss, jmesh)(
        jp, jnp.asarray(x), jnp.asarray(tgt))
    loss, grads = tpp.make_pipeline_train_fn(tstage, _tloss, tmesh)(
        tp, torch.tensor(x), torch.tensor(tgt))
    np.testing.assert_allclose(float(loss), float(wl), rtol=LOSS_RTOL)
    per_stage = [convert.from_flax({"params": {"layers_0": jax.tree.map(
        lambda l: np.asarray(l[s]), wg)}}) for s in range(4)]
    for name, g in grads.items():
        w = np.stack([d["layers.0." + name].numpy() for d in per_stage])
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL["rtol"],
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
