"""Group-wise packed int4 weights in the port (``models/quant.py``
``Int4Tensor``), held against the JAX package on the CPU.

The JAX package quantizes (``quantize_params(bits=4)``) and the bridge
carries the packed bytes, scales, group and packing axis across; the
port's own quantizer must produce the same bytes and scales bit for bit,
and its dequantized values and embedding rows are bit-equal too. The
forwards and the engine then run on the same int4 tree on both sides,
the JAX side with its w8a16 kernel opt-in on as its own tests run it
(int4 leaves never reach that kernel; they dequantize into ``einsum``),
its decode-attention opt-in off (ROADMAP queue C).

Tolerances on logits: fp32 compute, summation order only (1e-4 absolute
and relative; 2e-3 / 1e-3 with an int8 KV cache, ``TOLERANCE`` of
``tests/test_torch_model.py``); bf16 compute, the bf16 tolerance there
(6e-2 / 3e-2).
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.models import quant as jq
from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models import quant as tq
from instaslice_tpu_torch.models.lm import TpuLM
from instaslice_tpu_torch.serving import ServingEngine, api_server
from test_torch_model import TOLERANCE
from torch_port_util import both_params, configs, numpy_params, to_np

GROUP = 16


@pytest.fixture(autouse=True)
def _jax_kernel_opt_in(monkeypatch):
    monkeypatch.setenv("TPUSLICE_QUANT_KERNEL", "1")
    monkeypatch.delenv("TPUSLICE_DECODE_KERNEL", raising=False)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def pairs():
    """dtype -> (JAX config, port config, JAX int4 tree, the bridged port
    tree, the port tree before quantization), built once per dtype."""
    made = {}

    def get(dtype="fp32"):
        if dtype not in made:
            jcfg, tcfg = configs(dtype)
            jt, tt = both_params(jcfg, numpy_params(jcfg, 0),
                                 quantize=False)
            j4 = jq.quantize_params(jt, bits=4, group=GROUP)
            t4 = bridge.params_from_jax(jax.device_get(j4), device="cpu")
            made[dtype] = (jcfg, tcfg, j4, t4, tt)
        return made[dtype]

    return get


def _int4_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _int4_leaves(v, f"{path}/{k}")
    elif type(tree).__name__ == "Int4Tensor":
        yield path, tree


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_params_bits4_is_bit_equal_to_jax(pairs, dtype):
    """The port's quantizer on the unquantized tree gives the JAX
    package's packed bytes, scales, group and packing axis for every
    matmul weight (the stacked ones quantized one layer at a time);
    norms stay full precision."""
    _, _, j4, _, tt = pairs(dtype)
    t4 = tq.quantize_params(tt, bits=4, group=GROUP)
    got = dict(_int4_leaves(t4))
    want = dict(_int4_leaves(j4))
    assert sorted(got) == sorted(want) and len(got) == 7
    for path, w in want.items():
        g = got[path]
        assert g.p.dtype == torch.uint8 and g.s.dtype == torch.float32
        np.testing.assert_array_equal(g.p.numpy(), np.asarray(w.p), path)
        np.testing.assert_array_equal(g.s.numpy(), np.asarray(w.s), path)
        assert (g.group, g.pack_axis) == (w.group, w.pack_axis)
        assert g.shape == tuple(w.shape)
    assert got["/embed"].pack_axis == -1
    assert isinstance(t4["blocks"]["ln1"]["scale"], torch.Tensor)
    assert tq.quantize_params(t4, bits=4)["blocks"]["wq"] is t4["blocks"]["wq"]
    assert tq.quantize_params(t4, bits=8)["embed"] is t4["embed"]


def test_bridge_carries_int4_both_ways(pairs):
    _, _, j4, t4, _ = pairs()
    wq = t4["blocks"]["wq"]
    assert isinstance(wq, tq.Int4Tensor) and wq.device.type == "cpu"
    back = bridge.params_to_numpy(t4)
    p, s, group, axis = back["blocks"]["wq"]
    np.testing.assert_array_equal(p, np.asarray(j4["blocks"]["wq"].p))
    np.testing.assert_array_equal(s, np.asarray(j4["blocks"]["wq"].s))
    assert (group, axis) == (GROUP, -2)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dequantize_and_embed_lookup_are_bit_equal(pairs, dtype):
    """Every leaf dequantized to the model dtype and to float32 (the
    scales' dtype, with no argument), and an embedding gather, which
    dequantizes only the gathered packed rows."""
    jcfg, tcfg, j4, t4, _ = pairs(dtype)
    jleaves = dict(_int4_leaves(j4))
    for path, t in _int4_leaves(t4):
        j = jleaves[path]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(to_np(t.dequantize()),
                                      to_np(j.dequantize()))
        np.testing.assert_array_equal(to_np(t.dequantize(tcfg.dtype)),
                                      to_np(j.dequantize(jcfg.dtype)))
        np.testing.assert_array_equal(
            to_np(tq.weight(t.layer(1) if t.p.dim() == 3 else t,
                            tcfg.dtype)),
            to_np(jq.weight(j, jcfg.dtype)[1] if t.p.dim() == 3
                  else jq.weight(j, jcfg.dtype)))
    toks = np.array([[3, 9, 255], [61, 0, 7]])
    np.testing.assert_array_equal(
        to_np(tq.embed_lookup(t4["embed"], torch.from_numpy(toks))),
        to_np(jq.embed_lookup(j4["embed"], jnp.asarray(toks))))


def test_pack_unpack_round_trip_is_exact():
    """Every int in [-7, 7] survives packing at both nibble positions,
    along either axis."""
    vals = np.arange(-7, 8, dtype=np.float32)
    rng = np.random.default_rng(0)
    for axis in (-2, -1):
        w = rng.permutation(np.tile(vals, 64))[:32 * 30].reshape(32, 30)
        w[0, 0] = w[0, 1] = 7.0     # every group's amax is 7
        w = w if axis == -2 else w.T.copy()
        t = tq.quantize_tensor_int4(torch.from_numpy(w), axis, group=32)
        np.testing.assert_array_equal(t._unpack().numpy(), w.astype(np.int8))
        assert t.p.dtype == torch.uint8
        assert t.p.shape[axis] == 16 and t.s.shape[axis] == 1
        np.testing.assert_array_equal(t.dequantize().numpy(), w)


def test_errors_match_the_reference():
    """Odd contraction axes, a group that does not divide it, and a bit
    width other than 8 or 4 are refused with the reference's messages."""
    for shape, group in (((33, 8), 33), ((48, 8), 32)):
        with pytest.raises(ValueError) as want:
            jq.quantize_tensor_int4(jnp.ones(shape), group=group)
        with pytest.raises(ValueError) as got:
            tq.quantize_tensor_int4(torch.ones(shape), group=group)
        assert str(got.value) == str(want.value)
        assert "even and divisible" in str(got.value)
    with pytest.raises(ValueError, match="bits must be 8 or 4, got 3"):
        tq.quantize_params({"embed": torch.ones(4, 4)}, bits=3)


def test_tree_is_about_4x_smaller_than_bf16():
    """The capacity claim, on the port's own tree: at group 128 the
    packed bytes plus fp32 group scales are about a quarter of the bf16
    tree (0.5 + 4/128 bytes a weight against 2), and at group 16 under
    0.22 of an fp32 tree, the reference's bound."""
    bf16 = tlm.init_params(configs("bf16")[1], 0, device="cpu")

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, tq.Int4Tensor):
            return nbytes(tree.p) + nbytes(tree.s)
        return tree.numel() * tree.element_size()

    ratio = nbytes(tq.quantize_params(bf16, bits=4)) / nbytes(bf16)
    assert 0.25 < ratio < 0.3, ratio
    fp32 = tlm.init_params(configs("fp32")[1], 0, device="cpu")
    assert nbytes(tq.quantize_params(fp32, bits=4, group=16)) \
        < 0.22 * nbytes(fp32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_apply_and_apply_with_cache_match_jax(pairs, dtype):
    """int4 leaves through the full forward (one layer dequantized at a
    time) and through a prefill chunk and 3 decode steps over an int8 KV
    cache, against the JAX package's forwards over the same tree."""
    jcfg, tcfg, j4, t4, _ = pairs(dtype)
    atol, rtol = TOLERANCE[(dtype, False)]
    jm = JaxLM(jcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    np.testing.assert_allclose(
        to_np(tlm.apply(tcfg, t4, torch.from_numpy(toks))),
        to_np(jm.apply(j4, jnp.asarray(toks))), atol=atol, rtol=rtol)
    atol, rtol = TOLERANCE[(dtype, True)]
    jcache = jm.init_cache(2, 32, quant=True)
    tcache = tlm.init_cache(tcfg, 2, 32, quant=True, device="cpu")
    japply = jax.jit(jm.apply_with_cache)
    lens = np.zeros(2, np.int32)
    chunk = toks[:, :8]
    for step in range(4):
        jl, jcache = japply(j4, jnp.asarray(chunk), jcache, jnp.asarray(lens))
        tl, tcache = tlm.apply_with_cache(tcfg, t4, torch.from_numpy(chunk),
                                          tcache, torch.from_numpy(lens))
        np.testing.assert_allclose(to_np(tl), to_np(jl), atol=atol,
                                   rtol=rtol)
        lens = lens + chunk.shape[1]
        chunk = toks[:, 8 + step:9 + step]


def test_int4_engine_greedy_matches_jax(pairs):
    """fp32 compute, int4 weights, int8 KV cache (as ``--quantize-bits
    4`` serves): the port engine's greedy tokens are the JAX int4
    engine's, logprobs within the int8-KV logit tolerance."""
    jcfg, tcfg, j4, t4, _ = pairs()
    opts = dict(max_batch=3, max_len=64, prefill_len=8, kv_quant=True,
                radix_cache=False)
    jeng = JaxEngine(JaxLM(jcfg), j4, **opts)
    teng = ServingEngine(TpuLM(tcfg), t4, device="cpu", **opts)
    prompts = [[5, 9, 2, 7], list(range(30, 50)), [11] * 9]
    want = jeng.generate(prompts, max_new_tokens=10, block_size=4)
    got = teng.generate(prompts, max_new_tokens=10, block_size=4)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    np.testing.assert_allclose([r.logprobs for r in got],
                               [r.logprobs for r in want],
                               atol=TOLERANCE[("fp32", True)][0])
    assert teng.kv.used_blocks() == 0


# -------------------------------------------------------------- the server

DIMS = ["--device", "cpu", "--d-model", "64", "--n-heads", "2",
        "--n-layers", "2", "--d-ff", "128", "--vocab-size", "256"]
SERVE = DIMS + ["--max-len", "64", "--prefill-len", "8", "--max-batch", "4"]


def _post(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _build(*flags):
    return api_server.build_engine(
        api_server.build_parser().parse_args(SERVE + list(flags)))


@pytest.mark.parametrize("extra", [[], ["--window", "8"]])
def test_server_serves_int4(extra):
    """``--quantize-bits 4`` (implying ``--quantize``: int4 weights, int8
    KV cache), alone and with ``--window 8``: every matmul weight is the
    port quantizer's int4 of the seeded init, and a completion over HTTP
    equals the engine's own greedy run of the prompt."""
    eng = _build("--quantize-bits", "4", *extra)
    assert eng.kv_quant and eng.model.cfg.window == (8 if extra else 0)
    want = tq.quantize_params(eng.model.init(0, device="cpu"), bits=4)
    for path, leaf in _int4_leaves(eng.params):
        ref = dict(_int4_leaves(want))[path]
        assert torch.equal(leaf.p, ref.p) and torch.equal(leaf.s, ref.s)
    prompt = list(range(3, 24))
    srv = api_server.ApiServer(eng, host="127.0.0.1", port=0).start()
    try:
        out = _post(srv.url, "/v1/completions",
                    {"prompt": prompt, "max_tokens": 12})
        st = _post(srv.url, "/v1/stats")
    finally:
        srv.stop()
    served = out["choices"][0]["token_ids"]
    assert len(served) == 12 and st["kv"]["used"] == st["radix"]["blocks"]
    eng.radix.reclaim(eng.kv.total_blocks)
    assert eng.generate([prompt], max_new_tokens=12)[0].tokens == served


def _adapter_dirs(root, cfg):
    """Two rank-4 adapters on (wq, wv) with nonzero ``b``, written as port
    adapter checkpoints."""
    from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer
    from instaslice_tpu_torch.models.lora import LoraConfig, init_lora
    from instaslice_tpu_torch.models.train import TrainState, leaves

    dirs = []
    for i, name in enumerate(("billing", "support")):
        ad = init_lora(10 + i, cfg, LoraConfig(rank=4), device="cpu")
        gen = torch.Generator().manual_seed(20 + i)
        for ab in ad["blocks"].values():
            ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.5
        TrainCheckpointer(str(root / name)).save(TrainState(
            step=0, params=ad, opt_state=torch.optim.SGD(leaves(ad), lr=0.0)))
        dirs.append(root / name)
    return dirs


def _dequantized(tree, dtype):
    if isinstance(tree, dict):
        return {k: _dequantized(v, dtype) for k, v in tree.items()}
    return tq.weight(tree, dtype) if isinstance(tree, tq.Int4Tensor) else tree


def test_two_loras_over_an_int4_base_route_per_request(tmp_path):
    """Two ``--lora`` over ``--quantize-bits 4``: the base stays int4 and
    each request's rows add its adapter's delta to the dequantized
    product. A request's first-chunk logits over HTTP equal, within bf16
    rounding (5e-2 relative L2), an engine over the dequantized base with
    that adapter merged in, and sit far (at least 5x that) from the base
    and from the other adapter; the base request's are the int4 engine's
    without adapters, bit for bit."""
    from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer
    from instaslice_tpu_torch.models.lora import LoraConfig, merge_lora

    eng = _build("--quantize-bits", "4")
    billing, support = _adapter_dirs(tmp_path, eng.model.cfg)
    multi = _build("--quantize-bits", "4", "--lora", str(billing),
                   "--lora", str(support))
    assert isinstance(multi.params["blocks"]["wq"], tq.Int4Tensor)
    assert multi.adapter_names == {"billing": 1, "support": 2}
    prompt = [7, 3, 9, 21, 4, 4, 8, 100, 5]
    seen = []
    forward = multi._forward

    def logged(tokens, cache, lengths, *a, **kw):
        out = forward(tokens, cache, lengths, *a, **kw)
        if tokens.shape[1] > 1:
            seen.append((kw["aidx"].tolist(), out[0][0].clone()))
        return out

    multi._forward = logged
    srv = api_server.ApiServer(multi, host="127.0.0.1", port=0).start()
    try:
        for name in (None, "billing", "support"):
            body = {"prompt": prompt, "max_tokens": 3}
            if name:
                body["adapter"] = name
            assert len(_post(srv.url, "/v1/completions", body)
                       ["choices"][0]["token_ids"]) == 3
    finally:
        srv.stop()
        multi._forward = forward
    assert [a for a, _ in seen] == [[0], [0], [1], [1], [2], [2]]
    rows = [lg for _, lg in seen[::2]]        # each prompt's first chunk

    def first_chunk(e):
        got = []
        fwd = e._forward
        e._forward = lambda t, c, ln, *a, **kw: got.append(
            fwd(t, c, ln, *a, **kw)) or got[-1]
        try:
            e.generate([prompt], max_new_tokens=1)
        finally:
            e._forward = fwd
        return got[0][0][0]

    assert torch.equal(rows[0], first_chunk(eng))
    cfg = eng.model.cfg
    deq = _dequantized(eng.params, cfg.dtype)
    for i, d in enumerate((billing, support), start=1):
        merged = merge_lora(deq, TrainCheckpointer(str(d)).load_tree(), cfg,
                            LoraConfig(rank=4, alpha=16.0))
        want = first_chunk(ServingEngine(
            eng.model, merged, max_batch=4, max_len=64, prefill_len=8,
            kv_quant=True, device="cpu"))
        near = float((rows[i] - want).norm() / want.norm())
        far = min(float((rows[j] - want).norm() / want.norm())
                  for j in range(3) if j != i)
        assert near <= 5e-2 and far >= 5 * 5e-2, (i, near, far)
