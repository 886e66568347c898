"""Weight-only quantization in paddle_tpu_torch against paddle_tpu, on
the CPU: the int4 packing, `quantize_weight`, the quant_matmul plain
version (what a CPU tensor takes) against the reference's jnp twin and
its Pallas kernel in interpret mode, `quantize_model`, the byte counts,
the flags, and quantized Llama decode logits — with the packed weights
carried over from a `paddle_tpu` model through `models.convert`, and
packed by the port itself from the same fp32 weights.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances: integer codes, packed bytes and scales are compared for
equality; matmul outputs at 1e-5 in fp32 (the two packages sum the same
fp32 products in different orders) and within one bf16 ulp of the
output in bf16 (the same fp32 sum, rounded once to bf16 on both sides);
decode logits at 1e-4 (fp32, several layers of reordered sums) —
except with an int8 KV pool, where requantizing a page turns that fp32
noise (~1e-7 of a K/V value) into an occasional one-step code flip: the
pools' codes are pinned (at most 2 differ, each by one step, scales
within 2^-20 of each other) and the logits held at 2^-8 of the largest
logit (one flipped code moved them by 1.8e-3 of a 3.8 logit scale).
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)

from paddle_tpu import ops as jops
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny_config as j_tiny
from paddle_tpu.ops.pallas.quant_matmul import quant_matmul as pallas_qm
from paddle_tpu.quantization import weight_only as jwo

import paddle_tpu_torch.ops as tops
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                     load_numpy_state_dict, numpy_state_dict)
from paddle_tpu_torch.quantization import weight_only as two

CFG = dict(dtype="float32", num_hidden_layers=2, num_key_value_heads=2)
FORMATS = [("int8", 64), ("int4", 16), ("int4", 64)]


def _np(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _torch_of(w, dtype):
    t = torch.from_numpy(w)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax_of(w, dtype):
    a = jnp.asarray(w)
    return a.astype(jnp.bfloat16) if dtype == "bfloat16" else a


def test_pack_unpack_dequant_match_reference():
    rng = np.random.RandomState(0)
    q = rng.randint(-8, 8, (64, 48)).astype(np.int32)
    packed = tops.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jops.pack_int4(q)))
    np.testing.assert_array_equal(tops.unpack_int4(packed).numpy(), q)
    s4 = rng.rand(64 // 16, 48).astype(np.float32)
    np.testing.assert_array_equal(
        tops.dequant_weight(packed, torch.from_numpy(s4), "int4", 16).numpy(),
        np.asarray(jops.dequant_weight(jnp.asarray(packed.numpy()),
                                       jnp.asarray(s4), "int4", 16)))
    q8 = rng.randint(-127, 128, (32, 48)).astype(np.int8)
    s8 = rng.rand(48).astype(np.float32)
    np.testing.assert_array_equal(
        tops.dequant_weight(torch.from_numpy(q8), torch.from_numpy(s8),
                            "int8").numpy(),
        np.asarray(jops.dequant_weight(jnp.asarray(q8), jnp.asarray(s8),
                                       "int8")))
    with pytest.raises(ValueError, match="even K"):
        tops.pack_int4(torch.zeros((3, 4), dtype=torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt,group", FORMATS)
def test_quantize_weight_bit_identical(fmt, group, dtype):
    """Codes (packed bytes) and scales equal the reference's exactly:
    both compute the fp32 absmax, a true fp32 division and round half
    to even, so no code may differ."""
    rng = np.random.RandomState(len(fmt) + group)
    w = (rng.randn(256, 96) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                       # an all-zero column: the 1e-8 floor
    pj, sj = jwo.quantize_weight(_jax_of(w, dtype), fmt, group)
    pt, st = two.quantize_weight(_torch_of(w, dtype), fmt, group)
    assert pt.dtype == torch.int8 and st.dtype == _torch_of(w, dtype).dtype
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.float().numpy(), _np(sj))
    np.testing.assert_array_equal(
        two.dequantize_weight(pt, st, fmt, group).numpy(),
        np.asarray(jwo.dequantize_weight(pj, sj, fmt, group)))


@pytest.mark.parametrize("lead", [(6,), (2, 3)], ids=["2d", "3d"])
@pytest.mark.parametrize("fmt,group", FORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_quant_matmul_matches_twin_and_pallas(fmt, group, dtype, lead):
    rng = np.random.RandomState(group + len(lead))
    K, N = 128, 96
    w = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)
    x = rng.randn(*lead, K).astype(np.float32)
    qj, sj = jwo.quantize_weight(_jax_of(w, dtype), fmt, group)
    qt, st = two.quantize_weight(_torch_of(w, dtype), fmt, group)
    xj, xt = _jax_of(x, dtype), _torch_of(x, dtype)
    port = tops.quant_matmul(xt, qt, st, fmt, group)
    assert port.shape == lead + (N,) and port.dtype == xt.dtype
    port = port.float().numpy()
    for ref in (jops.xla_quant_matmul(xj, qj, sj, fmt, group),
                pallas_qm(xj, qj, sj, fmt, group, interpret=True)):
        ref = _np(ref)
        if dtype == "float32":
            np.testing.assert_allclose(port, ref, atol=1e-5, rtol=1e-5)
        else:
            # one bf16 ulp of the output (2^-8 of it, at least 2^-133)
            ulp = np.maximum(np.abs(ref), 2.0 ** -126) * 2.0 ** -7
            assert (np.abs(port - ref) <= ulp).all()
    np.testing.assert_array_equal(
        port, tops.plain_quant_matmul(xt, qt, st, fmt, group).float().numpy())


@pytest.mark.parametrize("case", ["unknown", "int4_no_group",
                                  "group_not_dividing", "packed_rows"])
def test_argument_errors_as_reference(case):
    rng = np.random.RandomState(1)
    w = rng.randn(64, 32).astype(np.float32)
    q4, s4 = two.quantize_weight(torch.from_numpy(w), "int4", 16)
    x = rng.randn(3, 64).astype(np.float32)
    args = {"unknown": (x, q4, s4, "int2", 16),
            "int4_no_group": (x, q4, s4, "int4", None),
            "group_not_dividing": (x, q4, s4, "int4", 24),
            "packed_rows": (x[:, :32], q4, s4, "int4", 16)}[case]
    xt = torch.from_numpy(args[0])
    with pytest.raises(ValueError):
        tops.quant_matmul(xt, *args[1:])
    with pytest.raises(ValueError):
        tops.plain_quant_matmul(xt, *args[1:])
    if case in ("unknown", "int4_no_group"):
        with pytest.raises(ValueError):
            jops.quant_matmul(jnp.asarray(args[0]),
                              jnp.asarray(q4.numpy()),
                              jnp.asarray(s4.numpy()), *args[3:])
    with pytest.raises(ValueError, match="divide K/2"):
        two.quantize_weight(torch.from_numpy(w), "int4", 24)
    with pytest.raises(ValueError, match="2-D"):
        two.quantize_weight(torch.zeros(4), "int8")


def _numpy_weights(jmodel, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in jmodel.state_dict().items():
        shape = tuple(p.shape)
        if len(shape) == 1:
            out[name] = (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        else:
            out[name] = (rng.randn(*shape) / np.sqrt(shape[0])) \
                .astype(np.float32)
    return out


def _pair(seed=3):
    jm = JLlama(j_tiny(**CFG))
    weights = _numpy_weights(jm, seed)
    jm.set_state_dict(weights)
    tm = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    load_numpy_state_dict(tm, weights)
    return jm, tm, weights


def _jax_state(jm):
    return {n: np.asarray(p.value) if p.value.dtype != jnp.bfloat16
            else np.asarray(p.value).astype(ml_dtypes.bfloat16)
            for n, p in jm.named_parameters()}


def test_quantize_model_idempotent_locked_and_named_as_reference():
    jm, tm, _ = _pair()
    jwo.quantize_model(jm, "int4", 32)
    assert two.quantize_model(tm, "int4", 32) is tm
    assert tm._weight_only == jm._weight_only == {"dtype": "int4",
                                                  "group_size": 32}
    # the same parameter names, shapes and dtypes as the reference's
    tsd = dict(tm.named_parameters())
    jsd = _jax_state(jm)
    assert sorted(tsd) == sorted(jsd)
    for n, p in tsd.items():
        assert tuple(p.shape) == jsd[n].shape, n
        assert (p.dtype == torch.int8) == (jsd[n].dtype == np.int8), n
        assert not p.requires_grad or p.dtype != torch.int8
    n_scales = sum(n.endswith("_scale") for n in tsd)
    assert n_scales == 7 * 2 + 1          # 7 per layer + the lm head
    before = {n: p.clone() for n, p in tm.named_parameters()}
    two.quantize_model(tm, "int4", 32)    # same configuration: untouched
    for n, p in tm.named_parameters():
        assert torch.equal(p, before[n]), n
    with pytest.raises(ValueError, match="already weight-only"):
        two.quantize_model(tm, "int8", 32)
    with pytest.raises(ValueError, match="already weight-only"):
        jwo.quantize_model(jm, "int8", 32)
    with pytest.raises(ValueError, match="unknown weight_only_dtype"):
        two.quantize_model(LlamaForCausalLM(llama_tiny_config(**CFG),
                                            device="cpu"), "int3")
    assert two.quantize_model(torch.nn.Linear(2, 2), "none") is not None
    with pytest.raises(ValueError, match="no weight-only"):
        two.quantize_model(torch.nn.Linear(2, 2), "int8")


@pytest.mark.parametrize("fmt,group", [("none", None)] + FORMATS)
def test_weight_pool_and_packed_bytes_match_reference(fmt, group):
    jm, tm, _ = _pair()
    assert two.weight_pool_bytes(tm) == jwo.weight_pool_bytes(jm)
    want = jwo.packed_bytes(jm, fmt, group)
    assert two.packed_bytes(tm, fmt, group) == want
    if fmt != "none":
        jwo.quantize_model(jm, fmt, group)
        two.quantize_model(tm, fmt, group)
        assert two.weight_pool_bytes(tm) == jwo.weight_pool_bytes(jm) == want
        with pytest.raises(ValueError, match="unquantized"):
            two.packed_bytes(tm, fmt, group)


def test_weight_only_flags_match_reference():
    for name in ("weight_only_dtype", "weight_only_group_size",
                 "kv_cache_dtype"):
        assert tflags.get_flag(name) == jflags.get_flag(name), name
        assert tflags._registry[name]["default"] \
            == jflags._registry[name]["default"], name
    assert tflags.get_flag("weight_only_dtype") == "none"
    assert tflags.get_flag("weight_only_group_size") == 64


def test_flag_resolves_quantization():
    tm = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    tflags.set_flags({"FLAGS_weight_only_dtype": "int4",
                      "FLAGS_weight_only_group_size": 16})
    try:
        two.quantize_model(tm)
    finally:
        tflags.set_flags({"FLAGS_weight_only_dtype": "none",
                          "FLAGS_weight_only_group_size": 64})
    assert tm._weight_only == {"dtype": "int4", "group_size": 16}
    assert tm.llama.layers[0].mlp.down_proj.shape == (384 // 2, 128)


def test_quantized_training_forward_raises():
    tm = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    ids = torch.ones((1, 4), dtype=torch.int32)
    tm(ids)                                   # unquantized: fine
    two.quantize_model(tm, "int8")
    with pytest.raises(RuntimeError, match="serving"):
        tm(ids)
    # the decode path serves it
    lg, _ = tm.forward_cached(ids, tm.init_cache(1, 8), 0)
    assert lg.shape == (1, 4, 512) and torch.isfinite(lg).all()


def test_convert_keeps_packed_dtypes():
    jm, tm, weights = _pair()
    two.quantize_model(tm, "int8")
    sd = numpy_state_dict(tm)
    assert sd["lm_head"].dtype == np.int8
    assert sd["lm_head_scale"].dtype == np.float32
    tm2 = two.quantize_model(
        LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu"), "int8")
    load_numpy_state_dict(tm2, sd)
    for n, p in tm2.named_parameters():
        assert torch.equal(p, dict(tm.named_parameters())[n]), n
    # a float weight cannot load into a packed parameter, nor packed
    # bytes into a float one
    with pytest.raises(ValueError, match="packed"):
        load_numpy_state_dict(tm2, dict(sd, lm_head=sd["lm_head"]
                                        .astype(np.float32)))
    fresh = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
    bad = dict(weights)
    bad["lm_head"] = sd["lm_head"]
    with pytest.raises(ValueError, match="packed"):
        load_numpy_state_dict(fresh, bad)


def _decode_logits_jax(jm, ids, kv_dtype, paged):
    B, s = ids.shape
    if not paged:
        cache = jm.init_cache(B, 32)
        lg, cache = jm.forward_cached(jnp.asarray(ids), cache, 0)
        outs = [lg]
        pos = s
        for t in range(3):
            lg, cache = jm.forward_cached(jnp.asarray(ids[:, t:t + 1]),
                                          cache, pos + t)
            outs.append(lg)
        return [_np(o) for o in outs], None
    ps, P_slot = 8, 4
    pt = np.arange(1, 1 + B * P_slot, dtype=np.int32).reshape(B, P_slot)
    cache = jm.init_paged_cache(1 + B * P_slot, ps, kv_dtype)
    pos = np.zeros((B,), np.int32)
    lg, cache = jm.forward_cached_paged(jnp.asarray(ids), cache,
                                        jnp.asarray(pt), jnp.asarray(pos))
    outs = [lg]
    for t in range(3):
        lg, cache = jm.forward_cached_paged(
            jnp.asarray(ids[:, t:t + 1]), cache, jnp.asarray(pt),
            jnp.asarray(pos + s + t))
        outs.append(lg)
    return [_np(o) for o in outs], {k: _np(v) for k, v in cache.items()}


@torch.inference_mode()
def _decode_logits_port(tm, ids, kv_dtype, paged):
    B, s = ids.shape
    t_ids = torch.from_numpy(ids)
    if not paged:
        cache = tm.init_cache(B, 32)
        lg, cache = tm.forward_cached(t_ids, cache, 0)
        outs = [lg]
        for t in range(3):
            lg, cache = tm.forward_cached(t_ids[:, t:t + 1], cache, s + t)
            outs.append(lg)
        return [o.numpy() for o in outs], None
    ps, P_slot = 8, 4
    pt = torch.arange(1, 1 + B * P_slot, dtype=torch.int32).reshape(B,
                                                                    P_slot)
    cache = tm.init_paged_cache(1 + B * P_slot, ps, kv_dtype)
    pos = torch.zeros((B,), dtype=torch.int32)
    lg, cache = tm.forward_cached_paged(t_ids, cache, pt, pos)
    outs = [lg]
    for t in range(3):
        lg, cache = tm.forward_cached_paged(t_ids[:, t:t + 1], cache, pt,
                                            pos + s + t)
        outs.append(lg)
    return [o.numpy() for o in outs], {k: v.numpy() for k, v in cache.items()}


@pytest.mark.parametrize("carry", ["convert", "port_quantizes"])
@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("fmt,group", [("int8", 64), ("int4", 32)])
def test_quantized_decode_logits_match_reference(fmt, group, kv, carry):
    """Prefill then three decode steps, dense (forward_cached) and paged
    (forward_cached_paged), quantized weights with an fp32 or int8 KV
    pool.  carry="convert": the reference packs, its state dict loads
    into a port model quantized at the same configuration;
    "port_quantizes": each package packs the same fp32 weights."""
    jm, tm, _ = _pair(seed=11)
    jwo.quantize_model(jm, fmt, group)
    if carry == "convert":
        fresh = LlamaForCausalLM(llama_tiny_config(**CFG), device="cpu")
        two.quantize_model(fresh, fmt, group)
        load_numpy_state_dict(fresh, _jax_state(jm))
        tm = fresh
    else:
        two.quantize_model(tm, fmt, group)
    for n, p in tm.named_parameters():
        if p.dtype == torch.int8:
            np.testing.assert_array_equal(p.numpy(), _jax_state(jm)[n])
    ids = np.random.RandomState(5).randint(1, 512, (2, 12)).astype(np.int32)
    for paged in (False, True):
        if kv == "int8" and not paged:
            continue                         # int8 KV is a paged pool
        refs, rcache = _decode_logits_jax(jm, ids, kv, paged)
        ports, pcache = _decode_logits_port(tm, ids, kv, paged)
        tol = dict(atol=1e-4, rtol=1e-4)
        if kv == "int8":
            for k in ("k", "v"):
                diff = np.abs(pcache[k].astype(np.int32)
                              - rcache[k].astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).sum() <= 2, k
                np.testing.assert_allclose(pcache[k + "_scale"],
                                           rcache[k + "_scale"],
                                           rtol=2.0 ** -20, atol=0)
            tol = dict(atol=2.0 ** -8 * np.abs(refs[0]).max(), rtol=0)
        for r, p in zip(refs, ports):
            np.testing.assert_allclose(p, r, **tol)


# clusters of 1-4 blocks of the wgmma body an H100 SXM holds at once, as
# ptt_quant_matmul_clusters (cudaOccupancyMaxActiveClusters) reports them
_H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30}
H100_SMS = 132


@pytest.mark.parametrize("M,K,N,fmt,want", [
    (256, 4096, 4096, "int8", (128, 2)),  # admission: 64 clusters of 2
    (256, 4096, 11008, "int8", (256, 1)),  # 86 strips of 256 rows
    (256, 11008, 4096, "int4", (256, 3)),  # 86 int4 tiles: 29, 29, 28
    (256, 4096, 32000, "int4", (256, 1)),  # 250 strips fill two waves
])
def test_quant_matmul_split_count(M, K, N, fmt, want):
    """(rows, splits) of the wgmma body: the admission chunks take it at
    the row tile and cluster size `_schedule` models fastest on an H100
    (`_H100_CLUSTERS`)."""
    qm = tops.kernel_module("quant_matmul")
    got = qm._schedule(M, K, N, fmt == "int4", lambda rows: _H100_CLUSTERS)
    assert got == want


@pytest.fixture(scope="module")
def decode_plan(tmp_path_factory):
    """The kernel library's decode plan (csrc/quant_matmul_plan.cuh,
    plain C++), built by the host's C++ compiler: (M, K, N, int4, group,
    scale bytes, x by TMA, sms) -> (body, splits, stages, smem bytes)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "the plan test needs a C++ compiler"
    d = tmp_path_factory.mktemp("qm_plan")
    (d / "shim.cpp").write_text(
        '#include "quant_matmul_plan.cuh"\n'
        'extern "C" void plan(int M, int K, int N, int int4, int group,\n'
        '                     int selem, int xtma, int sms, int* out) {\n'
        '  const ptt_qm::Plan p = ptt_qm::plan(M, K, N, int4 != 0, group,\n'
        '                                      selem, xtma != 0, sms);\n'
        '  out[0] = p.body; out[1] = p.splits; out[2] = p.stages;\n'
        '  out[3] = p.smem;\n'
        '}\n')
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), str(d / "shim.cpp"), "-o",
                    str(d / "plan.so")], check=True)
    fn = ctypes.CDLL(str(d / "plan.so")).plan
    fn.restype = None

    def plan(M, K, N, int4, group=64, selem=2, xtma=True, sms=H100_SMS):
        out = (ctypes.c_int * 4)()
        fn(*(ctypes.c_int(int(v)) for v in (M, K, N, int4, group, selem,
                                            xtma, sms)), out)
        return tuple(out)
    return plan


@pytest.mark.parametrize("M,K,N,fmt,sms,xtma,want", [
    (8, 4096, 4096, "int8", 132, True, (8, 4)),   # 7B q/k/v/o: 32 cols x 8
    (8, 4096, 32000, "int8", 132, True, (1, 4)),  # lm head: 250 blocks
    (8, 11008, 4096, "int8", 132, True, (8, 4)),  # down: 172 tiles over 8
    (8, 4096, 11008, "int4", 132, True, (4, 3)),  # gate/up: 86 cols x 4
    (8, 4096, 4096, "int4", 132, True, (8, 4)),   # 32 int4 tiles, 4 a block
    (16, 4096, 32000, "int8", 132, True, (1, 4)),
    (16, 4096, 32000, "int8", 132, False, (1, 4)),  # x staged: 128 KB
    (3, 200, 48, "int8", 132, True, (4, 3)),      # tiny K: one tile a block
    (1, 64, 16, "int8", 132, True, (1, 3)),       # one tile
    (8, 4096, 4096, "int8", 66, True, (4, 4)),    # half the SMs: 4 splits
])
def test_quant_matmul_decode_plan(decode_plan, M, K, N, fmt, sms, xtma,
                                  want):
    """The decode body's plan from shapes and the card's SM count alone:
    the split over K (the fewest blocks of a cluster, a power of two up to
    8, that give 1.5 blocks an SM, none of them empty), the weight stages
    in flight (8 an SM among its blocks, 3-8 a block, no more than a
    block walks but 3), and the shared memory that the ring (weight, x
    and int4 scale boxes a stage), a staged x share and the barriers
    take."""
    int4 = fmt == "int4"
    body, splits, stages, smem = decode_plan(M, K, N, int4, xtma=xtma,
                                             sms=sms)
    assert body == 1 and (splits, stages) == want
    n_k = -(-(K // 2 if int4 else K) // 64)
    per = -(-n_k // splits)
    assert (splits - 1) * per < n_k
    halves, rows = (2 if int4 else 1), (16 if M > 8 else 8)
    # a stage: the weight box, x's box of 8 or 16 rows a nibble half and
    # int4's group scale row (bf16) of each half, rounded up to 1 KB
    stage = 8192 + (halves * rows * 128 if xtma else 0)
    stage = -(-(stage + (2 * 128 * 2 if int4 else 0)) // 1024) * 1024
    xbytes = 0 if xtma else halves * per * rows * 128
    assert smem == 1024 + stages * stage + xbytes + 16 * stages <= 232448


@pytest.mark.parametrize("M,K,N,fmt,group,xtma,body", [
    (17, 4096, 4096, "int8", 64, True, 0),   # past 16 rows: not the body's
    (16, 65536, 4096, "int8", 64, True, 1),  # x by TMA: any K
    (16, 65536, 4096, "int8", 64, False, 0),  # staged x overflows its room
    (8, 65536, 4096, "int8", 64, False, 1),  # ... but not at 8 rows
    (8, 4096, 4096, "int4", 16, True, 1),    # int4 groups of 16 rows up
    (16, 11008, 4096, "int4", 128, False, 1),
    (8, 4104, 1040, "int4", 54, True, 0),    # not a multiple of 16
    (13, 200, 48, "int4", 50, False, 0),
])
def test_quant_matmul_decode_plan_domain(decode_plan, M, K, N, fmt, group,
                                         xtma, body):
    """Which shapes the decode body takes (the rest take the mma.sync
    body): up to 16 rows, int4 groups a multiple of 16 (a 16-row k step
    within one group); staged x (not by TMA) takes the whole share of a
    block in shared memory."""
    int4 = fmt == "int4"
    got = decode_plan(M, K, N, int4, group=group, xtma=xtma)
    assert got[0] == body
    if body and not xtma:
        n_k = -(-(K // 2 if int4 else K) // 64)
        per = -(-n_k // got[1])
        xbytes = (2 if int4 else 1) * per * (16 if M > 8 else 8) * 128
        assert xbytes <= 160 * 1024


def _view(ptr, shape, dtype):
    """A tensor over the CPU memory at address `ptr`."""
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype).view(shape)


class _QuantLib:
    """Stands in for the kernel library's ptt_quant_matmul: checks each
    call's arguments against `_build._SIGNATURES`, then writes the plain
    version's product where `out` points.  Its decode plan is the real
    one (`plan`) at an H100's SM count."""

    CTYPE = {ctypes.c_void_p: int, ctypes.c_int: int}
    DTYPE = {code: dt for dt, code in _build.DTYPE_CODES.items()}

    def __init__(self, plan):
        self.plan = plan
        self.calls = []
        self.plan_calls = []

    def ptt_quant_matmul_plan(self, *args):
        sig = _build._SIGNATURES["ptt_quant_matmul_plan"]
        assert len(args) == len(sig) and all(type(a) is int for a in args)
        dev, x, M, K, N, int4, group, scode, out = args
        self.plan_calls.append((dev, M, K, N, int4, group, scode))
        # x by TMA: 16-byte aligned rows of 16-byte strides, int4 halves of
        # whole 64-column boxes (csrc/quant_matmul.cu x_by_tma)
        xtma = x % 16 == 0 and K % 8 == 0 and (not int4 or K // 2 % 64 == 0)
        _view(out, (5,), torch.int32).copy_(torch.tensor(
            self.plan(M, K, N, int4, group, 4 if scode == 0 else 2, xtma)
            + (int(xtma),), dtype=torch.int32))
        return 0

    def ptt_quant_matmul(self, *args):
        sig = _build._SIGNATURES["ptt_quant_matmul"]
        assert len(args) == len(sig)
        for i, (a, c) in enumerate(zip(args, sig)):
            # part is a null pointer (None) where no scratch is needed
            assert type(a) is self.CTYPE[c] or (i == 9 and a is None), (i, a)
        self.calls.append(args)
        (dev, code, scode, int4, g, x, qw, sc, out, part, M, K, N, splits,
         rows, stream) = args
        dt, st = self.DTYPE[code], self.DTYPE[scode]
        fmt = "int4" if int4 else "int8"
        # the entry's contract: the decode plan's shapes take no split and
        # no scratch, every other shape at least one split
        xtma = x % 16 == 0 and K % 8 == 0 and (not int4 or K // 2 % 64 == 0)
        decode = (not rows and dt != torch.float32 and self.plan(
            M, K, N, int4, g, 4 if scode == 0 else 2, xtma)[0] == 1)
        assert (splits == 0 and part is None) if decode else splits >= 1
        w = _view(qw, (K // 2 if int4 else K, N), torch.int8)
        s = _view(sc, (K // g, N) if int4 else (N,), st)
        _view(out, (M, N), dt).copy_(tops.plain_quant_matmul(
            _view(x, (M, K), dt), w, s, fmt, g if int4 else None))
        return 0

    def ptt_quant_matmul_clusters(self, *args):
        sig = _build._SIGNATURES["ptt_quant_matmul_clusters"]
        assert len(args) == len(sig) and all(type(a) is int for a in args)
        dev, int4, rows, splits = args
        assert rows in (128, 256)
        return _H100_CLUSTERS[splits]


@pytest.mark.parametrize(
    "M,K,fmt,group,dt,aligned,rows,splits", [
        (8, 256, "int8", None, "bf16", True, 0, 0),      # decode body
        (1, 256, "int8", None, "bf16", True, 0, 0),
        (16, 256, "int8", None, "bf16", True, 0, 0),
        (8, 256, "int4", 32, "bf16", True, 0, 0),
        (5, 202, "int8", None, "fp16", False, 0, 0),     # unaligned, K % 8
        (8, 200, "int4", 50, "bf16", True, 0, 1),        # group % 16: mma
        (256, 4096, "int8", None, "bf16", True, 128, 4),  # admission: wgmma
        (256, 4096, "int4", 64, "bf16", True, 128, 4),
        (17, 256, "int8", None, "fp16", True, 128, 1),   # M > 16
        (256, 256, "int4", 32, "bf16", True, 0, 1),      # group % 64 != 0
        (100, 202, "int8", None, "bf16", True, 0, 1),    # K % 8 != 0
        (256, 256, "int8", None, "bf16", False, 0, 1),   # x not 16-aligned
        (256, 256, "int8", None, "fp32", True, 0, 1),    # CUDA-core body
    ], ids=["decode", "decode_m1", "decode_m16", "decode_int4",
            "decode_fp16_unaligned", "int4_g50_m8", "admit", "admit_int4", "m17_fp16",
            "int4_g32", "ragged_k", "x_unaligned", "fp32"])
def test_quant_matmul_launch_marshalling(monkeypatch, decode_plan, M, K, fmt,
                                         group, dt, aligned, rows, splits):
    """`_launch` as the card runs it, with the kernel library stood in
    for: the arguments in the C signature's order and types, the body
    the header gives the shape (wgmma, rows 128 or 256, only for
    bf16/fp16 x past 16 rows, K % 8 == 0, x 16-byte aligned, int4 groups
    a multiple of 64; the decode body, rows 0 and splits 0, for bf16/fp16
    x up to 16 rows at any alignment and int4 groups a multiple of 16,
    planned by the library; else
    mma.sync, rows 0), the split count (for the wgmma body sized by the
    stand-in's cluster capacity), fp32 partials [splits, M, N] only for
    the mma.sync body with splits > 1, the library's plan asked once a
    shape, and one launch counted per call."""
    qm = tops.kernel_module("quant_matmul")
    lib = _QuantLib(decode_plan)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "cuda_device_index", lambda *t: 0)
    monkeypatch.setattr(_build, "stream_of", lambda d: 0)
    monkeypatch.setattr(qm, "_capacity", {})
    monkeypatch.setattr(qm, "_plans", {})
    empty, made = torch.empty, []

    def spy_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", spy_empty)
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16,
             "fp32": torch.float32}[dt]
    rng = np.random.RandomState(M + K)
    N = 256
    w = torch.from_numpy((rng.randn(K, N) / np.sqrt(K)).astype(np.float32))
    qw, sc = two.quantize_weight(w.to(torch.bfloat16), fmt, group or 64)
    xs = torch.from_numpy(rng.randn(M * K + 1).astype(np.float32)).to(dtype)
    x = (xs[:M * K] if aligned else xs[1:]).view(M, K)
    assert (x.data_ptr() % 16 == 0) == aligned
    before = tops.launch_counts()["quant_matmul"]
    var = dict(qm.variant_launches)
    out = qm._launch(x, qw, sc, fmt, group)
    (call,) = lib.calls
    part = None if call[9] is None else [t for t in made
                                         if t.data_ptr() == call[9]][0]
    assert call == (0, _build.DTYPE_CODES[dtype],
                    _build.DTYPE_CODES[sc.dtype], int(fmt == "int4"),
                    group or 0, x.data_ptr(), qw.data_ptr(), sc.data_ptr(),
                    out.data_ptr(), call[9], M, K, N, splits, rows, 0)
    if rows or splits <= 1:
        assert part is None
    else:
        assert part.shape == (splits, M, N) and part.dtype == torch.float32
    # the plan is asked for 16-bit x off the wgmma body, once a shape
    assert lib.plan_calls == ([] if rows or dt == "fp32" else
                              [(0, M, K, N, int(fmt == "int4"), group or 0,
                                _build.DTYPE_CODES[sc.dtype])])
    assert out.shape == (M, N) and out.dtype == dtype
    assert torch.equal(out, tops.plain_quant_matmul(x, qw, sc, fmt, group))
    assert tops.launch_counts()["quant_matmul"] == before + 1
    assert qm.variant_launches[fmt] == var[fmt] + 1
    qm._launch(x, qw, sc, fmt, group)
    assert len(lib.plan_calls) == (0 if rows or dt == "fp32" else 1)
