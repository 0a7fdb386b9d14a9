"""The port's checkpoint loader (`dynamo_tpu_torch.models.loader`) against
the JAX package's `dynamo_tpu.models.loader`.

Each test writes its own tiny-debug checkpoint in the HF layout (numpy
seeds, `safetensors.numpy.save_file`; bf16 through `safetensors.torch`)
with its config.json: separate q/k/v/o and gate/up/down projections, or
Phi-3's fused `qkv_proj` and `gate_up_proj`, tied or untied head. Every
port parameter must equal the JAX loader's output exactly (head axes
flattened), and both packages' engines serving the same `model_path` must
give the same greedy streams. Nothing is downloaded.
"""

import dataclasses
import json
import logging

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from safetensors.torch import save_file as save_torch_file

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.models import loader as jloader
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models import loader, quant
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig

TINY = PRESETS["tiny-debug"]
E, H, KV, D, F_, V, L = (TINY.hidden_size, TINY.num_heads, TINY.num_kv_heads,
                         TINY.head_dim, TINY.intermediate_size,
                         TINY.vocab_size, TINY.num_layers)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def hf_config(tied: bool) -> dict:
    return {"architectures": ["LlamaForCausalLM"], "vocab_size": V,
            "hidden_size": E, "intermediate_size": F_,
            "num_hidden_layers": L, "num_attention_heads": H,
            "num_key_value_heads": KV, "head_dim": D,
            "rope_theta": TINY.rope_theta, "rms_norm_eps": TINY.rms_norm_eps,
            "max_position_embeddings": TINY.max_position_embeddings,
            "tie_word_embeddings": tied, "eos_token_id": TINY.eos_token_id,
            "bos_token_id": TINY.bos_token_id}


def hf_tensors(layout: str, tied: bool, seed: int = 0) -> dict:
    """HF-named f32 tensors, [out, in] as HF stores them."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    t = {"model.embed_tokens.weight": w(V, E),
         "model.norm.weight": 1 + w(E)}
    if not tied:
        t["lm_head.weight"] = w(V, E)
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + w(E)
        t[p + "post_attention_layernorm.weight"] = 1 + w(E)
        q, k, v = w(H * D, E), w(KV * D, E), w(KV * D, E)
        gate, up = w(F_, E), w(F_, E)
        if layout == "phi3":
            t[p + "self_attn.qkv_proj.weight"] = np.concatenate([q, k, v])
            t[p + "mlp.gate_up_proj.weight"] = np.concatenate([gate, up])
        else:
            t[p + "self_attn.q_proj.weight"] = q
            t[p + "self_attn.k_proj.weight"] = k
            t[p + "self_attn.v_proj.weight"] = v
            t[p + "mlp.gate_proj.weight"] = gate
            t[p + "mlp.up_proj.weight"] = up
        t[p + "self_attn.o_proj.weight"] = w(E, H * D)
        t[p + "mlp.down_proj.weight"] = w(E, F_)
    return t


def write_checkpoint(path, layout="separate", tied=True, dtype="float32",
                     shards=1, seed=0) -> dict:
    """The checkpoint under `path` (config.json and `shards` files)."""
    path.mkdir(parents=True, exist_ok=True)
    tensors = hf_tensors(layout, tied, seed)
    names = sorted(tensors)
    for s in range(shards):
        part = {n: tensors[n] for n in names[s::shards]}
        out = str(path / f"model-{s:05d}-of-{shards:05d}.safetensors")
        if dtype == "bfloat16":
            save_torch_file({n: torch.from_numpy(a).to(torch.bfloat16)
                             for n, a in part.items()}, out)
        else:
            save_file(part, out)
    (path / "config.json").write_text(json.dumps(hf_config(tied)))
    return tensors


def _port_value(jtree: dict, name: str, layer, shape) -> torch.Tensor:
    arr = np.asarray(jtree[name].astype(np.float32))
    arr = arr if layer is None else arr[layer]
    return torch.from_numpy(np.array(arr)).reshape(shape)


CASES = [("separate", True, "float32", 1), ("separate", False, "float32", 3),
         ("phi3", True, "float32", 1), ("phi3", False, "bfloat16", 2)]


@pytest.mark.parametrize("layout,tied,dtype,shards", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_checkpoint_loads_like_jax(tmp_path, layout, tied, dtype, shards):
    """Every port parameter equals the JAX loader's tensor exactly, and
    its HF source transposed (HF [out, in] -> the port's [in, out])."""
    tensors = write_checkpoint(tmp_path, layout, tied, dtype, shards)
    cfg = ModelConfig.from_model_name(str(tmp_path), dtype=dtype)
    assert dataclasses.replace(cfg, name="tiny-debug") == \
        dataclasses.replace(TINY, tie_word_embeddings=tied, dtype=dtype)
    files = loader.checkpoint_files(str(tmp_path))
    assert len(files) == shards
    jcfg = JModelConfig.from_model_name(str(tmp_path), dtype=dtype)
    jtree = jloader.load_hf_safetensors(jcfg, files)
    tdt = getattr(torch, dtype)
    model = loader.load_hf_safetensors(cfg, files, device="cpu", dtype=tdt)
    assert (model.lm_head is None) == tied
    n = 0
    for name, layer, owner in loader._targets(model):
        got = getattr(owner, name)
        assert got.dtype == tdt and got.is_contiguous()
        want = _port_value(jtree, name, layer, got.shape).to(tdt)
        assert torch.equal(got, want), (name, layer)
        n += 1
    assert n == 2 + (not tied) + 9 * L
    # the HF sources, transposed
    src = {k: torch.from_numpy(v).to(tdt) for k, v in tensors.items()}
    assert torch.equal(model.embed, src["model.embed_tokens.weight"])
    wo = src["model.layers.1.self_attn.o_proj.weight"]
    assert torch.equal(model.layers[1].wo, wo.t())
    if layout == "separate":
        assert torch.equal(model.layers[0].wk,
                           src["model.layers.0.self_attn.k_proj.weight"].t())
    else:
        qkv = src["model.layers.0.self_attn.qkv_proj.weight"]
        assert torch.equal(model.layers[0].wv, qkv[(H + KV) * D:].t())
        gu = src["model.layers.1.mlp.gate_up_proj.weight"]
        assert torch.equal(model.layers[1].w_up, gu[F_:].t())
    if not tied:
        assert torch.equal(model.lm_head, src["lm_head.weight"].t())


def test_empty_directory_gives_random_init_with_a_warning(tmp_path, caplog):
    cfg = dataclasses.replace(TINY, dtype="float32")
    with caplog.at_level(logging.WARNING, logger="dynamo_tpu_torch.loader"):
        model = loader.load_or_init(cfg, str(tmp_path), seed=3, device="cpu",
                                    dtype=torch.float32)
    assert "no safetensors under" in caplog.text
    ref = loader.init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              ref.named_parameters()):
        assert torch.equal(a, b), n


def write_gemma_checkpoint(path, arch: str, seed: int = 0) -> dict:
    """A tiny Gemma-2 or Gemma-3 HF checkpoint (`arch` the config's
    architecture) at tiny-debug's widths: input_layernorm, then HF's
    post_attention_layernorm (after attention here, not before the MLP),
    pre_feedforward_layernorm and post_feedforward_layernorm, with
    Gemma-3's q/k norms. Returns the HF-named tensors."""
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = hf_tensors("separate", tied=True, seed=seed)
    for i in range(L):
        p = f"model.layers.{i}."
        for name in ("pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            t[p + name + ".weight"] = rng.standard_normal(E).astype(
                np.float32)
        if arch.startswith("Gemma3"):
            for name in ("q_norm", "k_norm"):
                t[p + f"self_attn.{name}.weight"] = rng.standard_normal(
                    D).astype(np.float32)
    save_file(t, str(path / "model.safetensors"))
    cfg = dict(hf_config(tied=True), architectures=[arch],
               hidden_activation="gelu_pytorch_tanh", sliding_window=8,
               query_pre_attn_scalar=64)
    if arch.startswith("Gemma2"):
        cfg.update(attn_logit_softcapping=50.0, final_logit_softcapping=30.0)
    else:
        cfg.update(sliding_window_pattern=2, rope_local_base_freq=10000.0,
                   rope_theta=1e6, rope_scaling={"rope_type": "linear",
                                                 "factor": 8.0})
    (path / "config.json").write_text(json.dumps(cfg))
    return t


def test_unknown_quantization_and_unported_layouts_raise(tmp_path):
    """Bad settings raise, and the Gemma-2/3 layouts, once refused, load:
    a Gemma-2 and a Gemma-3 checkpoint written here load in both packages
    to equal arrays, the sandwich norms named as HF names them."""
    cfg = dataclasses.replace(TINY, dtype="float32")
    with pytest.raises(ValueError, match="unknown quantization 'fp4'"):
        loader.load_or_init(cfg, None, quantization="fp4", device="cpu",
                            dtype=torch.float32)
    write_checkpoint(tmp_path)
    files = loader.checkpoint_files(str(tmp_path))
    for arch in ("Gemma2ForCausalLM", "Gemma3ForCausalLM"):
        path = tmp_path / arch
        src = write_gemma_checkpoint(path, arch)
        gcfg = ModelConfig.from_model_name(str(path), dtype="float32")
        assert gcfg.post_norms and gcfg.sliding_window == 8
        gfiles = loader.checkpoint_files(str(path))
        jtree = jloader.load_hf_safetensors(
            JModelConfig.from_model_name(str(path), dtype="float32"), gfiles)
        model = loader.load_hf_safetensors(gcfg, gfiles, device="cpu",
                                           dtype=torch.float32)
        names = set()
        for name, layer, owner in loader._targets(model):
            got = getattr(owner, name)
            assert torch.equal(got, _port_value(jtree, name, layer,
                                                got.shape)), (name, layer)
            names.add(name)
        assert names == set(jtree)
        assert {"post_attn_norm", "post_mlp_norm"} <= names
        layer = model.layers[1]
        pre = "model.layers.1."
        for name, hf in (("mlp_norm", "pre_feedforward_layernorm"),
                         ("post_attn_norm", "post_attention_layernorm"),
                         ("post_mlp_norm", "post_feedforward_layernorm")):
            assert torch.equal(getattr(layer, name),
                               torch.from_numpy(src[pre + hf + ".weight"]))
    untied = dataclasses.replace(cfg, tie_word_embeddings=False)
    with pytest.raises(ValueError, match="no tensor 'lm_head.weight'"):
        loader.load_hf_safetensors(untied, files, device="cpu",
                                   dtype=torch.float32)


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quantization_after_the_load_matches_jax(tmp_path, mode):
    """load_or_init(quantization=...) on a checkpoint: the JAX
    load_or_init_params' int8 bytes and scales, carried into the port's
    layout."""
    write_checkpoint(tmp_path, "separate", tied=False)
    cfg = ModelConfig.from_model_name(str(tmp_path), dtype="float32")
    got = loader.load_or_init(cfg, str(tmp_path), quantization=mode,
                              device="cpu", dtype=torch.float32)
    jcfg = JModelConfig.from_model_name(str(tmp_path), dtype="float32")
    jq = jloader.load_or_init_params(jcfg, str(tmp_path), quantization=mode)
    want = loader.from_jax_params(cfg, jax.tree.map(np.asarray, jq),
                                  device="cpu", dtype=torch.float32,
                                  quantization=mode)
    assert quant.mode_of(got) == mode
    a, b = dict(got.named_buffers()), dict(want.named_buffers())
    assert a.keys() == b.keys() and len(a) == 2 * (2 + 7 * L)
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].stride() == b[k].stride(), k


def test_large_models_draw_int8_directly(monkeypatch):
    """With no checkpoint and more than DIRECT_INT8_PARAMS parameters, the
    int8 weights are drawn as such: seeded, within +-127, the operand
    layout, scales sigma / UNIFORM_INT8_STD (the dequantized weights'
    standard deviation is the spec's sigma), norms ones."""
    monkeypatch.setattr(loader, "DIRECT_INT8_PARAMS", 0)
    cfg = dataclasses.replace(TINY, dtype="float32",
                              tie_word_embeddings=False)
    models = [loader.load_or_init(cfg, None, seed=s, quantization="w8a8",
                                  device="cpu", dtype=torch.float32)
              for s in (1, 1, 2)]
    a, b, c = (dict(m.named_buffers()) for m in models)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.wq.q"], c["layers.0.wq.q"])
    m = models[0]
    assert quant.mode_of(m) == "w8a8"
    assert int(a["layers.1.w_down.q"].abs().max()) <= 127
    assert m.layers[0].w_gate.q.shape == (E, F_)
    assert m.layers[0].w_gate.q.stride() == (1, E)
    sigma = 1.0 / F_ ** 0.5
    assert torch.equal(m.layers[0].w_gate.scale,
                       torch.full((1, F_), sigma / loader.UNIFORM_INT8_STD))
    w = m.layers[1].w_gate.q.float() * m.layers[1].w_gate.scale
    assert abs(float(w.std()) / sigma - 1) < 0.05
    assert m.embed.scale.shape == (V, 1) and m.lm_head.scale.shape == (1, V)
    assert torch.equal(m.final_norm, torch.ones(E))
    assert quant.param_bytes(m) == (loader.num_params(cfg)
                                    - E * (2 * L + 1)  # norms, f32 below
                                    + 4 * E * (2 * L + 1)
                                    + 4 * (V + V + L * (H * D + 2 * KV * D
                                                        + 2 * E + 2 * F_)))


def _greedy(engine, make_req, prompts, max_tokens=10):
    for i, p in enumerate(prompts):
        engine.add_request(make_req(f"r{i}", p, max_tokens=max_tokens,
                                    temperature=0.0, ignore_eos=True))
    out = {}
    for _ in range(1000):
        if not engine.has_work:
            break
        for ev in engine.step():
            if ev.token_id >= 0:
                out.setdefault(ev.request_id, []).append(ev.token_id)
    return out


@pytest.mark.parametrize("layout,tied,quantization", [
    ("separate", False, "none"), ("phi3", True, "w8a8")])
def test_engines_serve_the_same_checkpoint(tmp_path, layout, tied,
                                           quantization):
    """Both packages' Engine on the same model_path (ModelConfig from its
    config.json; the second case quantized after the load): the same
    greedy streams, through a batched prefill, a chunked one and decode."""
    write_checkpoint(tmp_path, layout, tied, seed=5)
    base = dict(model="tiny-debug", model_path=str(tmp_path), page_size=16,
                num_pages=64, max_num_seqs=4, max_seq_len=512,
                prefill_chunk_tokens=32, enable_prefix_caching=False,
                quantization=quantization)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (6, 11, 50)]
    ref = _greedy(JEngine(JEngineConfig(**base, async_scheduling=False)),
                  JGenRequest, prompts)
    eng = Engine(EngineConfig(**base), device="cpu")
    assert eng.model_cfg.name == str(tmp_path)
    assert (eng.model.lm_head is None) == tied
    assert quant.mode_of(eng.model) == quantization
    assert _greedy(eng, GenRequest, prompts) == ref
