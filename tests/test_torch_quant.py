"""The port's int8 weights (`dynamo_tpu_torch.models.quant`) against the JAX
package's `dynamo_tpu.models.quant`, and the quantized engines against the
JAX engines.

Inputs come from numpy seeds at tiny-debug shapes. `quantize` must give the
JAX int8 bytes and scales exactly, in f32 and bf16, for every dense
QUANT_AXES entry. The quantized matmul is held against `quant.einsum` for
each projection spec in float32: W8A8 within rtol 1e-6 (the int8 product
is exact in both, the rescale is the same f32 ops), weight-only within
rtol 1e-5 (two frameworks' f32 matmul orders). The engines (tiny-debug,
float32 on the CPU) take the same int8 bytes, carried across from the JAX
tree, and must give the JAX engine's greedy streams token for token, with
first-step logprobs within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import quant as jquant
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models import loader, quant
from dynamo_tpu_torch.models.config import PRESETS

CFG = PRESETS["tiny-debug"]
E, H, KV, D, F_, V = (CFG.hidden_size, CFG.num_heads, CFG.num_kv_heads,
                      CFG.head_dim, CFG.intermediate_size, CFG.vocab_size)
MODES = ["int8", "w8a8"]
JCLS = {"int8": jquant.QTensor, "w8a8": jquant.QTensorA8}
BASE = dict(model="tiny-debug", page_size=16, num_pages=64, max_num_seqs=4,
            max_seq_len=512, prefill_chunk_tokens=32,
            enable_prefix_caching=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcfg(**kw):
    return dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32", **kw)


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(_jcfg(), jax.random.PRNGKey(0))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _weight(shape, seed, zero_channel=True):
    """Normal weights with one all-zero output channel (scale 1.0)."""
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if zero_channel:
        w[..., 0] = 0.0
    return w


def _stacked_shapes() -> dict:
    """name -> stacked JAX shape of every leaf of an untied dense
    tiny-debug, of tiny-moe-debug (the expert stacks) and of
    tiny-mla-debug (MLA's projections)."""
    shapes = {}
    for cfg in (dataclasses.replace(CFG, tie_word_embeddings=False),
                PRESETS["tiny-moe-debug"], PRESETS["tiny-mla-debug"]):
        for name, (shape, _, _) in loader.param_specs(cfg).items():
            shapes.setdefault(name, shape)
    return shapes


def test_quant_axes_are_the_dense_jax_entries():
    """The JAX entries of the leaves the port has: the dense ones and,
    since MoE and MLA were ported, the expert stacks and MLA's
    projections."""
    jspecs = {**jllama.param_specs(_jcfg(tie_word_embeddings=False)),
              **jllama.param_specs(dataclasses.replace(
                  JPRESETS["tiny-moe-debug"], dtype="float32")),
              **jllama.param_specs(dataclasses.replace(
                  JPRESETS["tiny-mla-debug"], dtype="float32"))}
    assert quant.QUANT_AXES == {k: v for k, v in jquant.QUANT_AXES.items()
                                if k in jspecs}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(quant.QUANT_AXES))
def test_quantize_matches_jax_bytes(name, dtype):
    """Every QUANT_AXES entry at its stacked JAX shape (the expert stacks
    at tiny-moe-debug's): the int8 values and the f32 scales are the JAX
    package's, byte for byte."""
    shape = _stacked_shapes()[name]
    w = _weight(shape, seed=len(name))
    if name == "embed":
        w[3] = 0.0  # a zero vocab row
    axes = quant.QUANT_AXES[name]
    jq = jquant.quantize(jnp.asarray(w).astype(dtype), axes)
    tq = quant.quantize(torch.from_numpy(w).to(getattr(torch, dtype)), axes)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert (tq.q.abs() <= 127).all()


# (JAX spec, the weight's name, JAX weight shape, contraction axes of the
# unstacked weight)
SPECS = [
    ("te,ehd->thd", "wq", (E, H, D), (0,)),
    ("te,ekd->tkd", "wk", (E, KV, D), (0,)),
    ("thd,hde->te", "wo", (H, D, E), (0, 1)),
    ("te,ef->tf", "w_gate", (E, F_), (0,)),
    ("tf,fe->te", "w_down", (F_, E), (0,)),
    ("te,ev->tv", "lm_head", (E, V), (0,)),
]


def _x(spec, t=6, seed=0):
    xl = spec.split(",")[0]
    dims = {"t": t, "e": E, "h": H, "d": D, "f": F_}
    x = np.random.default_rng(seed).normal(
        size=[dims[c] for c in xl]).astype(np.float32)
    x[1] = 0.0  # a zero token row: activation scale 1.0
    return x


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spec,name,shape,axes", SPECS,
                         ids=[s[0] for s in SPECS])
def test_matmul_matches_jax_einsum(spec, name, shape, axes, mode):
    x, w = _x(spec), _weight(shape, seed=7)
    want = np.asarray(jquant.einsum(spec, jnp.asarray(x),
                                    jquant.quantize(jnp.asarray(w), axes,
                                                    JCLS[mode])))
    k = int(np.prod([shape[a] for a in axes]))
    tw = quant.quantize_weight(name, torch.from_numpy(w).reshape(k, -1),
                               mode)
    got = quant.matmul(torch.from_numpy(x).reshape(x.shape[0], -1), tw)
    got = got.numpy().reshape(want.shape)
    assert np.isfinite(got).all() and not got[1].any()
    tol = dict(rtol=1e-6, atol=1e-6) if mode == "w8a8" else dict(rtol=1e-5,
                                                                 atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("mode", MODES)
def test_shared_activations_give_the_same_bits(mode):
    """One activation quantization serving q, k and v gives what each
    projection computes on its own."""
    x = torch.from_numpy(_x("te,ehd->thd"))
    w = quant.quantize_weight("wq", torch.from_numpy(_weight((E, H * D), 3)),
                              mode)
    act = quant.shared_activations(x, w)
    assert (act is not None) == (mode == "w8a8")
    assert torch.equal(quant.matmul(x, w, act), quant.matmul(x, w))


@pytest.mark.parametrize("mode", MODES)
def test_take_rows_and_tied_head_match_jax(mode):
    embed = _weight((V, E), seed=11, zero_channel=False)
    embed[5] = 0.0
    jq = jquant.quantize(jnp.asarray(embed), (1,), JCLS[mode])
    tq = quant.quantize_weight("embed", torch.from_numpy(embed), mode)
    ids = np.array([0, 5, 17, 511, 5], np.int32)
    rows = quant.take_rows(tq, torch.from_numpy(ids).long(), torch.float32)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jquant.take_rows(jq, jnp.asarray(ids),
                                                  jnp.float32)))
    assert not rows[1].any()
    x = _x("te,ev->tv")
    want = np.asarray(jquant.tied_head_einsum(jnp.asarray(x), jq))
    got = quant.tied_head(torch.from_numpy(x), tq).numpy()
    tol = 1e-6 if mode == "w8a8" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the plain embedding takes the plain paths
    pe = torch.from_numpy(embed)
    assert torch.equal(quant.tied_head(torch.from_numpy(x), pe),
                       torch.from_numpy(x) @ pe.t())


def test_zero_rows_quantize_to_scale_one_and_zeros():
    x = torch.zeros((3, 16))
    x[2, 4] = -2.5
    xq, xs = quant.activations(x)
    assert xs[:2].flatten().tolist() == [1.0, 1.0]
    assert not xq[:2].any() and xq[2, 4] == -127
    w = quant.quantize(torch.zeros((16, 8)), (0,))
    assert torch.equal(w.scale, torch.ones((1, 8)))
    y = quant.matmul(x, quant.quantize_weight(
        "wq", torch.randn(16, 8, generator=torch.Generator().manual_seed(0)),
        "w8a8"))
    assert torch.isfinite(y).all() and not y[:2].any()


@pytest.mark.parametrize("rows", [1, 8, 17])
def test_int_mm_is_exact(rows):
    g = torch.Generator().manual_seed(rows)
    a = torch.randint(-127, 128, (rows, 48), generator=g, dtype=torch.int8)
    b = quant.operand_layout(torch.randint(-127, 128, (48, 24), generator=g,
                                           dtype=torch.int8))
    got = quant.int_mm(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ b.long())


@pytest.mark.parametrize("mode", MODES)
def test_carried_int8_tree_equals_port_quantization(jparams, mode):
    """The JAX quantized tree carried across holds the bytes the port's own
    quantize_params gives the float tree; with_mode shares them."""
    jq = jquant.quantize_params(jparams, mode)
    tcfg = dataclasses.replace(CFG, dtype="float32")
    carried = loader.from_jax_params(tcfg, _np_tree(jq), device="cpu",
                                     dtype=torch.float32, quantization=mode)
    ported = loader.from_jax_params(tcfg, _np_tree(jparams), device="cpu",
                                    dtype=torch.float32, quantization=mode)
    assert quant.mode_of(carried) == quant.mode_of(ported) == mode
    assert quant.is_quantized(carried)
    assert not quant.is_quantized(loader.from_jax_params(
        tcfg, _np_tree(jparams), device="cpu", dtype=torch.float32))
    a, b = dict(carried.named_buffers()), dict(ported.named_buffers())
    assert a.keys() == b.keys() and len(a) == 2 * (1 + 7 * CFG.num_layers)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert carried.layers[0].wq.q.stride() == (1, E)  # operand layout
    assert quant.param_bytes(carried) == jquant.param_bytes(jq)
    other = "int8" if mode == "w8a8" else "w8a8"
    twin = quant.with_mode(carried, other)
    assert quant.mode_of(twin) == other
    assert twin.layers[1].w_up.q.data_ptr() == carried.layers[1].w_up.q.data_ptr()
    assert twin.final_norm is carried.final_norm
    with pytest.raises(ValueError, match="quantization='int8' or 'w8a8'"):
        loader.from_jax_params(tcfg, _np_tree(jq), device="cpu",
                               dtype=torch.float32)


def _run(engine, make_req, reqs):
    for rid, prompt, kw in reqs:
        engine.add_request(make_req(rid, prompt, **kw))
    events = {}
    for _ in range(2000):
        if not engine.has_work:
            break
        for ev in engine.step():
            if ev.token_id >= 0:
                events.setdefault(ev.request_id, []).append(ev)
    return events


def _reqs(lengths, max_tokens, seed=0):
    rng = np.random.default_rng(seed)
    reqs = [(f"r{i}", rng.integers(0, 256, size=n).tolist(),
             dict(max_tokens=max_tokens, temperature=0.0, ignore_eos=True))
            for i, n in enumerate(lengths)]
    reqs[0][2]["logprobs"] = 5
    return reqs


def _assert_streams_match(got, ref):
    assert {r: [e.token_id for e in evs] for r, evs in got.items()} == \
        {r: [e.token_id for e in evs] for r, evs in ref.items()}
    first_ref, first_got = ref["r0"][0], got["r0"][0]
    assert first_got.logprob == pytest.approx(first_ref.logprob, rel=1e-4,
                                              abs=1e-4)
    np.testing.assert_allclose([v for _, v in first_got.top_logprobs],
                               [v for _, v in first_ref.top_logprobs],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode,extra", [
    ("int8", {}),
    ("w8a8", {}),
    ("w8a8", dict(kv_cache_dtype="int8", mixed_batch_tokens=32)),
], ids=["int8", "w8a8", "w8a8-int8-pools-mixed"])
def test_quantized_engine_matches_jax(jparams, mode, extra):
    """The same int8 bytes in both engines: three same-bucket prompts and
    one 70-token prompt over the 32-token chunk (with the mixed step, it
    rides mixed steps beside the decoding streams), greedy."""
    jq = jquant.quantize_params(jparams, mode)
    cfg = dict(BASE, quantization=mode, **extra)
    reqs = _reqs([5, 9, 12, 70], 10)
    ref = _run(JEngine(JEngineConfig(**cfg, async_scheduling=False),
                       params=jq), JGenRequest, reqs)
    eng = Engine(EngineConfig(**cfg), params=_np_tree(jq), device="cpu")
    got = _run(eng, GenRequest, reqs)
    _assert_streams_match(got, ref)
    assert quant.mode_of(eng.model) == mode
    if "mixed_batch_tokens" in extra:
        assert eng.metrics.mixed_count > 0


def test_w8a8_windows_equal_one_step(jparams):
    """w8a8 weights in 4-step async windows give the 1-step engine's
    greedy and seeded sampled streams and logprobs exactly."""
    tree = _np_tree(jquant.quantize_params(jparams, "w8a8"))
    reqs = _reqs([7, 30], 11, seed=3)
    reqs.append(("s", list(range(3, 40)),
                 dict(max_tokens=9, temperature=0.8, top_p=0.9, seed=5,
                      ignore_eos=True)))
    outs = []
    for steps in (1, 4):
        eng = Engine(EngineConfig(**BASE, quantization="w8a8",
                                  num_scheduler_steps=steps,
                                  async_scheduling=steps > 1),
                     params=tree, device="cpu")
        outs.append({r: [(e.token_id, e.logprob, e.top_logprobs)
                         for e in evs]
                     for r, evs in _run(eng, GenRequest, reqs).items()})
        assert eng.metrics.decode_steps > 0
    assert outs[0] == outs[1]


def test_engine_refuses_weights_of_another_mode(jparams):
    tcfg = dataclasses.replace(CFG, dtype="float32")
    model = loader.from_jax_params(tcfg, _np_tree(jparams), device="cpu",
                                   dtype=torch.float32, quantization="int8")
    with pytest.raises(ValueError, match="quantization='w8a8'"):
        Engine(EngineConfig(**BASE, quantization="w8a8"), params=model,
               device="cpu")
    with pytest.raises(ValueError, match="unknown quantization 'int4'"):
        Engine(EngineConfig(**BASE, quantization="int4"), device="cpu")
