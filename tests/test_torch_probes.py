"""The port's probe and attribution tools (myrtle_vision_tpu_torch/perf/)
against the JAX package's TPU tools in tools/perf/, on the CPU.

The probes' plain versions (which CPU tensors take) against the Pallas
bodies of the TPU probes K12 (attn_microbench.py) and K13
(mlp_microbench.py), run through their own ``_call`` in interpret mode
with the module's shape constants monkeypatched to small sizes; K14
(layout_probe.py) against its ``_dot`` on the same per-head slices, since
``run_case`` has no interpret mode and its bodies are local to ``main``.
Same inputs, made with numpy from a seed.  The attribution tools run at
depth 2 on the CPU and print every component.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.ops.fused_attention_block import (
    fused_attention_block as jax_attention_block,
)
from myrtle_vision_tpu.ops.fused_mlp import fused_mlp_block as jax_mlp_block
from myrtle_vision_tpu_torch.perf import (
    attn_microbench,
    int8_component_bench,
    layout_probe,
    mlp_microbench,
    train_gap_bench,
)
from myrtle_vision_tpu_torch.training.classification import make_loss_fn
from myrtle_vision_tpu_torch.training.trainer import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, C, H, M = 4, 64, 2, 256
D = C // H
SCALE = D ** -0.5
# the JAX config values the TPU tools set when they are imported
JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_entry_size_bytes",
                  "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def tools():
    """The three TPU probes, loaded by path; the jax.config values they
    set at import restored afterwards, so that the rest of the worker
    keeps its own compilation cache settings."""
    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_KEYS}
    try:
        mods = {}
        for name in ("attn_microbench", "mlp_microbench", "layout_probe"):
            spec = importlib.util.spec_from_file_location(
                f"tpu_{name}", os.path.join(REPO, "tools", "perf",
                                            f"{name}.py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mods


def close_bf16(out, ref):
    """The bf16 bar: |d| <= 2^-7 |ref| + 2^-8 per element (one bf16 step
    of a value, where the two frameworks sum in another order)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    excess = np.abs(out - ref) / (2.0 ** -7 * np.abs(ref) + 2.0 ** -8)
    assert excess.max() <= 1.0, (np.abs(out - ref).max(), excess.max())


def inputs(n, seed):
    """numpy draws of the TPU tool's inputs at the small sizes: x (B, N,
    C) std 1, wqkv (C, 3C) and wp (C, C) std 0.05 with biases std 0.01,
    the MLP's w1, w2 std 0.05 with biases std 0.01."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return {"x": rng.randn(B, n, C).astype(f),
            "wqkv": (rng.randn(C, 3 * C) * 0.05).astype(f),
            "bqkv": (rng.randn(3 * C) * 0.01).astype(f),
            "wp": (rng.randn(C, C) * 0.05).astype(f),
            "bp": (rng.randn(C) * 0.01).astype(f),
            "w1": (rng.randn(C, M) * 0.05).astype(f),
            "b1": (rng.randn(M) * 0.01).astype(f),
            "w2": (rng.randn(M, C) * 0.05).astype(f),
            "b2": (rng.randn(C) * 0.01).astype(f)}


def port_inputs(a):
    """The port tools' input dict (:func:`attn_microbench.make_inputs`'s
    keys and dtypes) of the numpy draws."""
    bf = torch.bfloat16
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    for k in ("x", "w1", "w2"):
        t[k] = t[k].to(bf)
    t["ln_s"] = torch.ones(C, dtype=bf)
    t["ln_b"] = torch.zeros(C, dtype=bf)
    return t


# ---------------------------------------------------------------- K12

# the TPU tool's Pallas body (and its keyword arguments) of each variant
K12_BODIES = {
    "pvrow": ("_kernel_pvrow", {}),
    "rowmajor": ("_kernel_rowmajor", {"defer": False}),
    "defer": ("_kernel_rowmajor", {"defer": True}),
    "none": ("_kernel_rowmajor", {"defer": True, "softmax": "none"}),
    "nomax": ("_kernel_rowmajor", {"defer": True, "softmax": "nomax"}),
    "sumdot": ("_kernel_rowmajor", {"defer": True, "softmax": "sumdot"}),
    "pipe": ("_kernel_pipe", {}),
    "dotonly": ("_kernel_dotonly", {}),
}


def jax_k12(tool, name, a):
    """The TPU tool's variant ``name`` on the numpy draws, with the casts
    of its ``main`` (attn_microbench.py :325-418)."""
    dt = jnp.bfloat16
    x = jnp.asarray(a["x"]).astype(dt)
    s, b = jnp.ones((C,), dt), jnp.zeros((C,), dt)
    wqkv, bqkv = jnp.asarray(a["wqkv"]), jnp.asarray(a["bqkv"])
    wp, bp = jnp.asarray(a["wp"]), jnp.asarray(a["bp"])
    if name == "base":
        return jax_attention_block(x, s, b, wqkv.astype(dt), bqkv,
                                   wp.astype(dt), bp, H, SCALE)
    if name == "mlp":
        return jax_mlp_block(x, s, b, jnp.asarray(a["w1"]).astype(dt),
                             jnp.zeros((M,)), jnp.asarray(a["w2"]).astype(dt),
                             jnp.zeros((C,)))
    body, kw = K12_BODIES[name]
    if name == "pvrow":
        extras = [wqkv.reshape(C, 3, H, D).transpose(1, 2, 0, 3).astype(dt),
                  bqkv.reshape(3, H, D), wp.astype(dt), bp.astype(dt)]
    else:
        extras = [wqkv.astype(dt), bqkv, wp.astype(dt), bp.astype(dt)]
    kernel = functools.partial(getattr(tool, body), group=1, **kw)
    return tool._call(kernel, x, s, b, extras, 1)


@pytest.mark.parametrize("n", [20, 50])
@pytest.mark.parametrize("name", ["base", "pvrow", "rowmajor", "defer",
                                  "pipe", "dotonly", "none", "nomax",
                                  "sumdot", "mlp"])
def test_k12_variant_matches_the_tpu_probe(tools, monkeypatch, name, n):
    tool = tools["attn_microbench"]
    for k, v in dict(B=B, N=n, C=C, H=H, D=D, SCALE=SCALE).items():
        monkeypatch.setattr(tool, k, v)
    a = inputs(n, seed=n)
    if name == "mlp":  # the TPU tool's MLP calibration has no biases
        a["b1"][:] = 0
        a["b2"][:] = 0
    ref = np.asarray(jax_k12(tool, name, a).astype(jnp.float32))
    out = attn_microbench.variants(port_inputs(a), H, plain=True)[name]()
    assert out.dtype == torch.bfloat16 and out.shape == (B, n, C)
    close_bf16(out.float().numpy(), ref)


def test_k12_weights_carried_across():
    """``variant_weights`` gives each variant the TPU tool's casts:
    ``pvrow``'s head-major w3 and bq3 hold the (C, 3C) weight's columns,
    ``base`` keeps an fp32 bp, the probe chains a bf16 one."""
    a = {k: torch.from_numpy(v) for k, v in inputs(20, 0).items()}
    w = attn_microbench.variant_weights(a["wqkv"], a["bqkv"], a["wp"],
                                        a["bp"], H)
    w3, bq3 = w["pvrow"][:2]
    assert w3.shape == (3, H, C, D) and bq3.shape == (3, H, D)
    for t in range(3):
        for h in range(H):
            col = t * C + h * D
            assert torch.equal(w3[t, h], a["wqkv"][:, col:col + D].to(
                torch.bfloat16))
            assert torch.equal(bq3[t, h], a["bqkv"][col:col + D])
    assert w["base"][3].dtype == torch.float32
    assert all(w[k][3].dtype == torch.bfloat16
               for k in attn_microbench.CORE_MODES)


@pytest.mark.parametrize("name", ["xlaattn", "xlamlp"])
def test_k12_yardsticks_compute_the_blocks(name):
    """The eager yardsticks compute the blocks' functions: against the
    port's production chains, within two bf16 steps of the output plus
    one of 1 (they round the products before their biases, and F.gelu
    is the exact erf)."""
    fns = attn_microbench.variants(port_inputs(inputs(50, 3)), H,
                                   plain=True)
    out = fns[name]().float()
    ref = fns["mlp" if name == "xlamlp" else "base"]().float()
    assert ((out - ref).abs() <= 2.0 ** -6 * ref.abs() + 2.0 ** -7).all()


def test_k12_none_parts_hold_apart():
    """Mode ``none`` divides by a sum of signed scores: its parts (the
    undivided product, the rowsum) compose to the divided output."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    qkv = torch.from_numpy(np.random.RandomState(5).randn(B, 50, 3 * C)
                           .astype(np.float32)).to(torch.bfloat16)
    u, m, ssum = K.attention_core_probe_plain(qkv, H, SCALE, "none",
                                              parts=True)
    out = K.attention_core_probe_plain(qkv, H, SCALE, "none")
    assert torch.equal(m, torch.zeros_like(m))
    div = u.float().view(B, 50, H, D) / ssum.permute(0, 2, 1)[..., None]
    torch.testing.assert_close(div.reshape(B, 50, C), out.float(),
                               rtol=2.0 ** -7, atol=0)


# ---------------------------------------------------------------- K13

@pytest.mark.parametrize("n", [20, 50])
@pytest.mark.parametrize("name", ["prod", "base", "nogelu", "noexp",
                                  "nodiv", "pipe"])
def test_k13_variant_matches_the_tpu_probe(tools, monkeypatch, name, n):
    tool = tools["mlp_microbench"]
    for k, v in dict(B=B, N=n, C=C, M=M).items():
        monkeypatch.setattr(tool, k, v)
    a = inputs(n, seed=100 + n)
    dt = jnp.bfloat16
    j = [jnp.asarray(a["x"]).astype(dt), jnp.ones((C,), dt),
         jnp.zeros((C,), dt), jnp.asarray(a["w1"]).astype(dt),
         jnp.asarray(a["b1"]), jnp.asarray(a["w2"]).astype(dt),
         jnp.asarray(a["b2"])]
    if name == "prod":
        ref = jax_mlp_block(*j)
    else:  # two images a program, so that pipe overlaps one with the next
        ref = tool._call(*j, 2, name)
    ref = np.asarray(ref.astype(jnp.float32))
    out = mlp_microbench.variants(port_inputs(a), plain=True)[name]()
    out = mlp_microbench.joined(out)
    assert out.dtype == torch.bfloat16 and out.shape == (B, n, C)
    close_bf16(out.float().numpy(), ref)


# ---------------------------------------------------------------- K14

def jax_case(lp, name, xs, heads):
    """The TPU tool's body of case ``name`` on one image's operands (its
    ``main`` :162-224), the heads concatenated."""
    n = xs[0].shape[0]

    def per_head(fn):
        return jnp.concatenate([fn(h) for h in range(heads)], axis=-1)

    a, b = xs
    bodies = {
        "dv  e^T@du   implicit (0,0)": lambda: per_head(lambda h: lp._dot(
            a[:, h * n:(h + 1) * n], b[:, h * D:(h + 1) * D], ((0,), (0,)))),
        "dv  (e.T)@du explicit T": lambda: per_head(lambda h: lp._dot(
            a[:, h * n:(h + 1) * n].T, b[:, h * D:(h + 1) * D],
            ((1,), (0,)))),
        "dp  du@v^T   implicit (1,1)": lambda: per_head(lambda h: lp._dot(
            a[:, h * D:(h + 1) * D], b[:, h * D:(h + 1) * D], ((1,), (1,)))),
        "dp  du@(v.T) explicit T": lambda: per_head(lambda h: lp._dot(
            a[:, h * D:(h + 1) * D], b[:, h * D:(h + 1) * D].T,
            ((1,), (0,)))),
        "s   q@k^T    implicit (1,1) REF": lambda: per_head(
            lambda h: lp._dot(a[:, h * D:(h + 1) * D],
                              b[:, h * D:(h + 1) * D], ((1,), (1,)))),
        "dw  xn^T@dqkv implicit (0,0)": lambda: lp._dot(a, b, ((0,), (0,))),
        "dw  (xn.T)@dqkv explicit T": lambda: lp._dot(a.T, b, ((1,), (0,))),
        "dxn dqkv@w^T implicit (1,1)": lambda: lp._dot(a, b, ((1,), (1,))),
        "dxn dqkv@wT  pre-transposed": lambda: lp._dot(a, b, ((1,), (0,))),
        "qkv xn@w     natural REF": lambda: lp._dot(a, b, ((1,), (0,))),
    }
    return bodies[name]()


K14_CASES = [c[0] for c in layout_probe.cases(20, C, H)]


@pytest.mark.parametrize("n", [20, 50])
@pytest.mark.parametrize("name", K14_CASES)
def test_k14_case_matches_the_tpu_probe(tools, name, n):
    lp = tools["layout_probe"]
    case = {c[0]: c[1:] for c in layout_probe.cases(n, C, H)}[name]
    shapes, contract, per_head, explicit = case
    rng = np.random.RandomState(7 + n)
    ops = [torch.from_numpy((rng.randn(*(((B,) if batched else ()) + shape))
                             * 0.1).astype(np.float32)).to(torch.bfloat16)
           for shape, batched in shapes]
    heads = H if per_head else None
    out = layout_probe.case_fn(layout_probe.K.PLAIN, *ops, contract, heads,
                               explicit)().numpy()
    jops = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in ops]
    ref = np.stack([np.asarray(jax_case(
        lp, name, [o[i] if batched else o
                   for o, (_, batched) in zip(jops, shapes)], H))
        for i in range(B)])
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# ------------------------------------------------------- attribution

def one_call(fn, device, iters=20, warmup=3):
    """A stand-in for the tools' timer: one call, no time (a host-clock
    time of the CPU would measure nothing of the card)."""
    fn()
    return 0.0


def test_train_gap_bench_prints_every_component(monkeypatch, capsys):
    monkeypatch.setattr(train_gap_bench, "time_ms", one_call)
    results = train_gap_bench.main(["--device", "cpu", "--batch", "1",
                                    "--depth", "2", "--iters", "1"])
    printed = capsys.readouterr().out
    for name in train_gap_bench.COMPONENTS:
        assert name in results and f"\n{name} " in printed, name
    for gap in ("opt (train-grad)", "grad - blocks", "infer - blocks"):
        assert gap in printed and gap in results


def test_train_gap_grad_is_the_train_steps_gradient():
    """The tool's ``grad`` is the gradient that ``make_train_step``
    computes before its optimizer step, on the same weights and batch."""
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(1)
    images = torch.randn(1, 224, 224, 3, generator=g)
    batch = {"image": images[None],
             "label": torch.tensor([[3]], dtype=torch.int64)}
    state = train_gap_bench.build(2, cpu, 0)
    make_train_step(make_loss_fn(state.model), 1)(state, batch, 1e-3)
    other = train_gap_bench.build(2, cpu, 0)
    train_gap_bench.grad_step(other.model, make_loss_fn(other.model),
                              {k: v[0] for k, v in batch.items()})
    for (name, p), q in zip(state.model.named_parameters(),
                            other.model.parameters()):
        if q.grad is None:  # the loss does not reach it
            assert not p.grad.any(), name
        else:
            assert torch.equal(p.grad, q.grad), name


def test_int8_component_bench_prints_every_component(monkeypatch, capsys):
    monkeypatch.setattr(int8_component_bench, "time_ms", one_call)
    results = int8_component_bench.main(["--device", "cpu", "--batch", "1",
                                         "--depth", "2", "--iters", "1"])
    printed = capsys.readouterr().out
    for name in int8_component_bench.COMPONENTS:
        assert name in results and f"\n{name} " in printed, name
    assert "edges" in results and "edges (full-blk)" in printed
