"""The PyTorch port's op layer held against the JAX package on the CPU.

Covers the weight bridge, import hygiene (the port loads neither JAX nor
the JAX package), the plain versions of the four ported kernels against
the JAX package's Pallas kernels (interpret mode on the CPU), and the
exact ops: int8 weight quantization, the embedding gather, sampling
filters, RMSNorm, RoPE and the KV-cache quantizer. Inputs come from
seeded numpy and go to both packages.
"""

import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.models import lm as jlm
from instaslice_tpu.models import quant as jquant
from instaslice_tpu.ops import flash_decode as jfd
from instaslice_tpu.ops import quant_matmul as jqm
from instaslice_tpu.serving import sampling as jsampling
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models import quant as tquant
from instaslice_tpu_torch.ops import flash_decode as tfd
from instaslice_tpu_torch.ops import quant_matmul as tqm
from instaslice_tpu_torch.ops import launch_counts, reset_launch_counts
from instaslice_tpu_torch.serving import sampling as tsampling

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "instaslice_tpu_torch"


def _bits(a) -> np.ndarray:
    """Raw bit pattern of a numpy / ml_dtypes array, for exact equality."""
    a = np.asarray(a)
    return a.view(np.dtype(f"u{a.dtype.itemsize}"))


# ------------------------------------------------------------------ bridge

class TestBridge:
    def test_bf16_tree_round_trips_bit_exact(self):
        rng = np.random.default_rng(0)
        tree = {
            "embed": jnp.asarray(rng.standard_normal((64, 32)), jnp.bfloat16),
            "blocks": {"wq": jnp.asarray(rng.standard_normal((2, 32, 32)),
                                         jnp.bfloat16),
                       "ln1": {"scale": jnp.asarray(
                           rng.standard_normal((2, 32)), jnp.float32)}},
        }
        host = jax.device_get(tree)
        port = bridge.params_from_jax(host, device="cpu")
        assert port["embed"].dtype == torch.bfloat16
        assert port["blocks"]["ln1"]["scale"].dtype == torch.float32
        back = bridge.params_to_numpy(port)
        for path, leaf in jax.tree_util.tree_leaves_with_path(host):
            got = back
            for p in path:
                got = got[p.key]
            assert got.dtype == leaf.dtype
            np.testing.assert_array_equal(_bits(got), _bits(leaf))

    def test_quantized_tree_round_trips_bit_exact(self):
        rng = np.random.default_rng(1)
        tree = jquant.quantize_params({
            "embed": jnp.asarray(rng.standard_normal((64, 32)), jnp.bfloat16),
            "blocks": {"w_in": jnp.asarray(
                rng.standard_normal((2, 32, 48)), jnp.bfloat16)},
        })
        host = jax.device_get(tree)
        port = bridge.params_from_jax(host, device="cpu")
        assert isinstance(port["blocks"]["w_in"], tquant.QuantizedTensor)
        back = bridge.params_to_numpy(port)
        for key, qt in (("embed", host["embed"]),
                        ("w_in", host["blocks"]["w_in"])):
            got = back[key] if key == "embed" else back["blocks"][key]
            np.testing.assert_array_equal(got[0], qt.q)
            np.testing.assert_array_equal(_bits(got[1]), _bits(qt.s))


# ---------------------------------------------------------- import hygiene

def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


#: the serving plane's modules and the jax-free ones copied for it: both
#: checks below must reach every one of them
SERVING_PLANE = {
    "instaslice_tpu_torch.serving.api_server",
    "instaslice_tpu_torch.serving.scheduler",
    "instaslice_tpu_torch.serving.engine",
    "instaslice_tpu_torch.serving.kvcache",
    "instaslice_tpu_torch.serving.sampling",
    "instaslice_tpu_torch.serving.distributed",
    "instaslice_tpu_torch.serving.dcn_serve_smoke",
    "instaslice_tpu_torch.api.constants",
    "instaslice_tpu_torch.faults",
    "instaslice_tpu_torch.metrics.metrics",
    "instaslice_tpu_torch.obs.journal",
    "instaslice_tpu_torch.obs.profiler",
    "instaslice_tpu_torch.utils.guards",
    "instaslice_tpu_torch.utils.lockcheck",
    "instaslice_tpu_torch.utils.trace",
}


#: the parallel layer: both checks below must reach it too
PARALLEL = {
    "instaslice_tpu_torch.parallel",
    "instaslice_tpu_torch.parallel.collectives",
    "instaslice_tpu_torch.parallel.meshenv",
    "instaslice_tpu_torch.parallel.pipeline",
    "instaslice_tpu_torch.parallel.ring",
}


#: the slice/device layer: both checks below must reach it too
DEVICE_LAYER = {
    "instaslice_tpu_torch.topology",
    "instaslice_tpu_torch.topology.grid",
    "instaslice_tpu_torch.topology.profiles",
    "instaslice_tpu_torch.topology.placement",
    "instaslice_tpu_torch.topology.policy",
    "instaslice_tpu_torch.topology.frag",
    "instaslice_tpu_torch.topology.mig",
    "instaslice_tpu_torch.device",
    "instaslice_tpu_torch.device.backend",
    "instaslice_tpu_torch.device.registry",
    "instaslice_tpu_torch.device.fake",
    "instaslice_tpu_torch.device.nvml",
    "instaslice_tpu_torch.device.select",
    "instaslice_tpu_torch.api.types",
    "instaslice_tpu_torch.agent",
    "instaslice_tpu_torch.agent.handoff",
}


#: the device plugin and its hand-written wire, the rendezvous smoke and
#: the plugin's CLI: both checks below must reach them too, and none of
#: them may import grpc or google.protobuf
DEVICE_PLUGIN = {
    "instaslice_tpu_torch.deviceplugin",
    "instaslice_tpu_torch.deviceplugin.proto",
    "instaslice_tpu_torch.deviceplugin.hpack",
    "instaslice_tpu_torch.deviceplugin.h2",
    "instaslice_tpu_torch.deviceplugin.wire",
    "instaslice_tpu_torch.deviceplugin.server",
    "instaslice_tpu_torch.parallel.dcn_smoke",
    "instaslice_tpu_torch.cli.deviceplugin_main",
    "instaslice_tpu_torch.cli.runtime",
}


#: the node agent and the Kubernetes layer it runs on: both checks below
#: must reach them too, and none of them may import yaml (the card's
#: machine has no PyYAML; kubeconfigs are read by kube/kubeconfig.py)
AGENT_LAYER = {
    "instaslice_tpu_torch.kube",
    "instaslice_tpu_torch.kube.client",
    "instaslice_tpu_torch.kube.fake",
    "instaslice_tpu_torch.kube.informer",
    "instaslice_tpu_torch.kube.coalesce",
    "instaslice_tpu_torch.kube.kubeconfig",
    "instaslice_tpu_torch.kube.real",
    "instaslice_tpu_torch.kube.httptest",
    "instaslice_tpu_torch.utils.election",
    "instaslice_tpu_torch.utils.reconcile",
    "instaslice_tpu_torch.utils.probes",
    "instaslice_tpu_torch.utils.timeutil",
    "instaslice_tpu_torch.utils.envutil",
    "instaslice_tpu_torch.agent.discovery",
    "instaslice_tpu_torch.agent.gpugrid",
    "instaslice_tpu_torch.agent.reconciler",
    "instaslice_tpu_torch.agent.runner",
    "instaslice_tpu_torch.cli.agent_main",
}


#: the controller, its CRD and its CLI: both checks below must reach them
CONTROLLER = {
    "instaslice_tpu_torch.api",
    "instaslice_tpu_torch.api.crd",
    "instaslice_tpu_torch.controller",
    "instaslice_tpu_torch.controller.gates",
    "instaslice_tpu_torch.controller.gpugrid",
    "instaslice_tpu_torch.controller.reconciler",
    "instaslice_tpu_torch.controller.defrag",
    "instaslice_tpu_torch.controller.runner",
    "instaslice_tpu_torch.cli.controller_main",
}


#: the simulator, the network nemesis and the operator CLIs: both checks
#: below must reach them too
OPERATOR_CLI = {
    "instaslice_tpu_torch.sim",
    "instaslice_tpu_torch.faults.netchaos",
    "instaslice_tpu_torch.cli.demo",
    "instaslice_tpu_torch.cli.tpuslicectl",
}


#: the fleet router and the load generator: both checks below must reach
#: them too
FLEET_TOOLS = {
    "instaslice_tpu_torch.serving.router",
    "instaslice_tpu_torch.serving.loadgen",
}


def test_port_imports_neither_jax_nor_the_jax_package():
    assert SERVING_PLANE | PARALLEL | DEVICE_LAYER | DEVICE_PLUGIN | \
        AGENT_LAYER | CONTROLLER | OPERATOR_CLI | FLEET_TOOLS <= \
        set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'instaslice_tpu'\n"
        "             or m.startswith('instaslice_tpu.')\n"
        "             or m.split('.')[0] in ('ml_dtypes', 'grpc', 'yaml')\n"
        "             or m == 'google.protobuf'\n"
        "             or m.startswith('google.protobuf.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_never_name_jax_or_the_jax_package():
    # ml_dtypes at module level: the bridge (a test tool that hands bf16
    # trees back to the JAX package) imports it inside the one function
    # that needs it, which the import check above never calls
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib)(?:\.|\s|$)"
                     r"|^(?:import|from)\s+ml_dtypes(?:\.|\s|$)"
                     r"|^\s*(?:import|from)\s+(?:grpc|google\.protobuf|yaml)"
                     r"(?:\.|\s|$)"
                     r"|instaslice_tpu\.|import instaslice_tpu(?:\s|$)",
                     re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    scanned = {".".join(f.relative_to(REPO).with_suffix("").parts)
               .removesuffix(".__init__") for f in files}
    assert SERVING_PLANE | PARALLEL | DEVICE_LAYER | DEVICE_PLUGIN | \
        AGENT_LAYER | CONTROLLER | OPERATOR_CLI | FLEET_TOOLS <= scanned
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert len(files) > 10 and not hits, hits


# ------------------------------------------- B1: decode attention (plain)

def _mk_cache(L, B, Hkv, S, hd, seed):
    rng = np.random.default_rng(seed)
    k3 = rng.integers(-127, 128, (L, B, Hkv, S, hd), dtype=np.int8)
    v3 = rng.integers(-127, 128, (L, B, Hkv, S, hd), dtype=np.int8)
    ks3 = rng.uniform(0.01, 0.1, (L, B, Hkv, S)).astype(np.float32)
    vs3 = rng.uniform(0.01, 0.1, (L, B, Hkv, S)).astype(np.float32)
    return k3, ks3, v3, vs3


def _both_decode(li, lengths, s_attn, S=256, seed=0):
    L, B, Hkv, hd, G = 3, len(lengths), 2, 16, 2
    rng = np.random.default_rng(seed + 100)
    q4 = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    k_loc = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    v_loc = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    cache = _mk_cache(L, B, Hkv, S, hd, seed)
    lens = np.asarray(lengths, np.int32)
    lg_l = np.einsum("bkgd,bkd->bkg", q4 * hd ** -0.5, k_loc)
    jo, jm, jl = jfd.quant_decode_attention(
        jnp.asarray(q4), *(jnp.asarray(c) for c in
                           (cache[0], cache[1], cache[2], cache[3])),
        jnp.asarray(lens), jnp.int32(li), s_attn)
    want = jfd.merge_local(jo, jm, jl, jnp.asarray(lg_l), jnp.asarray(v_loc))
    t = [torch.from_numpy(c) for c in cache]
    o, m, l = tfd.quant_decode_attention(
        torch.from_numpy(q4), t[0], t[1], t[2], t[3],
        torch.from_numpy(lens), li, s_attn)
    got = tfd.merge_local(o, m, l, torch.from_numpy(lg_l),
                          torch.from_numpy(v_loc))
    return got, want, (o, m, l)


@pytest.mark.parametrize("li", [0, 2])
def test_decode_attention_plain_matches_jax_kernel(li):
    """Staggered lengths including an EMPTY prefix; held through
    merge_local (raw ``l`` differs by design on empty rows). fp32 both
    sides; 2e-5 covers the different softmax and summation orders."""
    got, want, _ = _both_decode(li, [0, 5, 100, 256], 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_decode_attention_s_attn_bounds_the_prefix():
    """s_attn bounds the read: lengths <= 256 give the same result at
    s_attn 256 and 512, and both match the JAX kernel."""
    got_b, want_b, parts_b = _both_decode(0, [200, 256], 256, S=512, seed=5)
    got_f, _, parts_f = _both_decode(0, [200, 256], 512, S=512, seed=5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(parts_b, parts_f):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_decode_attention_empty_row_convention():
    """The kernel convention the plain version shares: an empty prefix
    gives m = -1e30, l = 0, acc = 0, and the merge returns the local
    value exactly."""
    got, _, (o, m, l) = _both_decode(1, [0, 7], 256)
    assert float(m[0].max()) == float(np.float32(-1e30))
    assert float(l[0].abs().max()) == 0.0
    assert float(o[0].abs().max()) == 0.0
    assert float(l[1].min()) > 0.0


# ------------------------------------------------- B2-B4: w8a16 (plain)

def _x(m, k, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(dtype)


def _jq(w, axis=-2):
    return jquant.quantize_tensor(jnp.asarray(w), reduce_axis=axis)


@pytest.mark.parametrize("m", [1, 8, 32, 33])
def test_quant_matmul_plain_matches_jax_kernel(m):
    """B4 (unstacked (K, N)); fp32 sums in another order: 1e-4."""
    x = _x(m, 256, m)
    qt = _jq(_x(256, 384, 99))
    want = jqm.quant_matmul(jnp.asarray(x), qt.q, qt.s)
    got = tqm.quant_matmul(torch.from_numpy(x), torch.tensor(
        np.asarray(qt.q)), torch.tensor(np.asarray(qt.s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_quant_matmul_t_plain_matches_jax_kernel():
    """B3: the (N, K) embedding layout with per-row scales."""
    x = _x(16, 256, 1)
    qt = _jq(_x(384, 256, 2), axis=-1)
    want = jqm.quant_matmul(jnp.asarray(x), qt.q, qt.s, transpose_w=True)
    got = tqm.quant_matmul(torch.from_numpy(x),
                           torch.tensor(np.asarray(qt.q)),
                           torch.tensor(np.asarray(qt.s)),
                           transpose_w=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_quant_matmul_stacked_plain_matches_jax_kernel_every_layer():
    """B2: the layer index must pick exactly layer li's weights."""
    L, K, N = 3, 256, 384
    rng = np.random.default_rng(9)
    x = _x(8, K, 3)
    q3 = rng.integers(-127, 128, (L, K, N), dtype=np.int8)
    s3 = rng.uniform(0.01, 0.1, (L, 1, N)).astype(np.float32)
    for li in range(L):
        want = jqm.quant_matmul_stacked(jnp.asarray(x), jnp.asarray(q3),
                                        jnp.asarray(s3), jnp.int32(li))
        got = tqm.quant_matmul_stacked(torch.from_numpy(x),
                                       torch.from_numpy(q3),
                                       torch.from_numpy(s3), li)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stacked", [False, True])
def test_quant_matmul_bf16_activations(stacked):
    """bf16 x, bf16-stored scales: both sides convert int8 exactly and
    multiply bf16 x int8 exactly in fp32, so only the fp32 summation
    order differs (1e-4 relative to outputs of magnitude ~10)."""
    x = jnp.asarray(_x(32, 512, 4), jnp.bfloat16)
    w = jnp.asarray(_x(512, 256, 5), jnp.bfloat16)
    qt = jquant.quantize_tensor(w)
    xt = bridge.params_from_jax({"x": jax.device_get(x)}, device="cpu")["x"]
    qs = bridge.params_from_jax(jax.device_get({"q": qt.q, "s": qt.s}),
                                device="cpu")
    if stacked:
        want = jqm.quant_matmul_stacked(x, qt.q[None], qt.s[None],
                                        jnp.int32(0))
        got = tqm.quant_matmul_stacked(xt, qs["q"][None], qs["s"][None], 0)
    else:
        want = jqm.quant_matmul(x, qt.q, qt.s)
        got = tqm.quant_matmul(xt, qs["q"], qs["s"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


def test_wrappers_count_no_launch_on_cpu_tensors():
    reset_launch_counts()
    x = torch.ones(2, 128)
    q = torch.ones(128, 128, dtype=torch.int8)
    s = torch.ones(1, 128)
    tqm.quant_matmul(x, q, s)
    tqm.quant_matmul_t(x, q, s)
    tqm.quant_matmul_stacked(x, q[None], s[None], 0)
    assert set(launch_counts().values()) == {0}


def test_routing_predicates_and_the_plain_routes(monkeypatch):
    """Which shapes each kernel family is built for, and that the model's
    "auto" attention and int8 decode branch take the plain formulation
    where no kernel is built (the wrappers themselves still raise there
    on the card: tests/test_torch_cuda.py)."""
    from instaslice_tpu_torch.ops import flash_attention as tfa
    assert [tfa.kernel_built(hd) for hd in (16, 64, 128, 256)] == [
        False, False, True, False]
    assert [tfd.kernel_built(hd, g) for hd, g in [
        (64, 1), (128, 8), (128, 4), (16, 2), (256, 4), (128, 16),
        (64, 3)]] == [True, True, True, False, False, False, False]

    def no_kernel(*a, **kw):
        raise AssertionError("routed to a kernel that is not built")

    monkeypatch.setattr(tlm, "flash_attention", no_kernel)
    monkeypatch.setattr(tlm, "quant_decode_attention", no_kernel)
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((1, 5, 4, 64)), dtype=torch.float32)
    kv = torch.tensor(rng.standard_normal((1, 5, 2, 64)), dtype=torch.float32)
    out = tlm._attention(q, kv, kv, impl="auto")
    torch.testing.assert_close(out, tlm._attention(q, kv, kv, impl="xla"),
                               rtol=0, atol=0)
    with pytest.raises(AssertionError, match="not built"):
        tlm._attention(q, kv, kv, impl="flash")
    cfg = tlm.ModelConfig(vocab_size=64, d_model=64, n_heads=16,
                          n_kv_heads=1, n_layers=1, d_ff=64,
                          dtype=torch.float32, remat=False)
    params = tlm.init_params(cfg, 0, device="cpu")
    cache = tlm.init_cache(cfg, 2, 16, quant=True, device="cpu")
    logits, _ = tlm.apply_with_cache(cfg, params, torch.tensor([[3], [4]]),
                                     cache, torch.tensor([2, 5],
                                                         dtype=torch.int32))
    assert logits.shape == (2, 1, 64) and bool(torch.isfinite(logits).all())


def test_plain_routes_on_the_card_are_logged_once_and_reported(
        monkeypatch, caplog):
    """A call on the card at a shape no kernel is built for is logged
    once per shape, and a serving engine names its decode attention
    route in ``/v1/stats`` (``engine.attention_route``)."""
    from types import SimpleNamespace

    from instaslice_tpu_torch.serving.engine import ServingEngine
    monkeypatch.setattr(tlm, "_plain_logged", set())
    with caplog.at_level("WARNING", logger="instaslice_tpu_torch.models.lm"):
        for shape in ((("hd", 16), ("G", 2)), (("hd", 16), ("G", 2)),
                      (("hd", 64), ("G", 16))):
            tlm._log_plain_route("int8 decode attention (B1)", shape)
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 2 and all("no kernel is built" in m for m in msgs)

    def route(device, kv_quant, n_heads, n_kv_heads, d_model):
        cfg = tlm.ModelConfig(d_model=d_model, n_heads=n_heads,
                              n_kv_heads=n_kv_heads)
        eng = SimpleNamespace(model=SimpleNamespace(cfg=cfg),
                              device=torch.device(device),
                              kv_quant=kv_quant)
        return ServingEngine.attention_route(eng)

    assert route("cuda", True, 32, 8, 4096) == "B1"
    assert route("cuda", True, 16, 1, 1024) == (
        "plain (no B1 built for hd 64, G 16)")
    assert route("cuda", True, 2, 2, 32) == "plain (no B1 built for hd 16, G 1)"
    assert route("cuda", False, 32, 8, 4096) == "plain (kv cache not int8)"
    assert route("cpu", True, 32, 8, 4096) == "plain (cpu)"


def test_quant_matmul_contraction_mismatch_raises():
    with pytest.raises(ValueError, match="contraction mismatch"):
        tqm.quant_matmul(torch.ones(2, 64), torch.ones(128, 8,
                                                       dtype=torch.int8),
                         torch.ones(8))


# ----------------------------------------------------------- exact ops

@pytest.mark.parametrize("dtype,axis", [("float32", -2), ("bfloat16", -2),
                                        ("bfloat16", -1)])
def test_quantize_tensor_exact(dtype, axis):
    w = jnp.asarray(_x(3 * 64, 96, 7).reshape(3, 64, 96), dtype)
    want = jquant.quantize_tensor(w, reduce_axis=axis)
    wt = bridge.params_from_jax({"w": jax.device_get(w)}, device="cpu")["w"]
    got = tquant.quantize_tensor(wt, reduce_axis=axis)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    back = bridge.params_to_numpy({"s": got.s})["s"]
    np.testing.assert_array_equal(_bits(back), _bits(np.asarray(want.s)))


def test_embed_lookup_exact():
    table = jnp.asarray(_x(64, 32, 8), jnp.bfloat16)
    qt = jquant.quantize_tensor(table, reduce_axis=-1)
    toks = np.array([[0, 5, 63], [7, 7, 1]], np.int32)
    want = jquant.embed_lookup(qt, jnp.asarray(toks))
    port = bridge.params_from_jax({"e": jax.device_get(qt)}, device="cpu")
    got = tquant.embed_lookup(port["e"], torch.from_numpy(toks))
    back = bridge.params_to_numpy({"g": got})["g"]
    np.testing.assert_array_equal(_bits(back), _bits(np.asarray(want)))


@pytest.mark.parametrize("top_k,top_p,min_p", [(5, 1.0, 0.0),
                                               (0, 0.8, 0.0),
                                               (0, 1.0, 0.1),
                                               (20, 0.9, 0.05)])
def test_filter_logits_exact(top_k, top_p, min_p):
    logits = _x(4, 64, 11) * 3.0
    want = jsampling.filter_logits(jnp.asarray(logits), top_k, top_p, min_p)
    got = tsampling.filter_logits(torch.from_numpy(logits), top_k, top_p,
                                  min_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_repetition_penalty_and_logprob():
    logits = _x(2, 32, 12)
    seen = np.random.default_rng(13).random((2, 32)) < 0.3
    want = jsampling.apply_repetition_penalty(jnp.asarray(logits),
                                              jnp.asarray(seen), 1.3)
    got = tsampling.apply_repetition_penalty(torch.from_numpy(logits),
                                             torch.from_numpy(seen), 1.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    toks = np.array([3, 30])
    np.testing.assert_allclose(
        tsampling.token_logprob(got, torch.from_numpy(toks)).numpy(),
        np.asarray(jsampling.token_logprob(want, jnp.asarray(toks))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    """fp32: rsqrt/mean differ by an ulp at most (1e-6). bf16: the same,
    then one bf16 rounding, which such an ulp can flip (tol = 1 bf16
    ulp, 2**-8 relative)."""
    x = jnp.asarray(_x(4, 256, 14) * 3, dtype)
    scale = jnp.asarray(1 + 0.1 * _x(1, 256, 15)[0])
    want = jlm._rmsnorm(x, scale)
    tx = bridge.params_from_jax(jax.device_get({"x": x, "s": scale}),
                                device="cpu")
    got = tlm._rmsnorm(tx["x"], tx["s"])
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_rope_per_row_positions():
    """(B, S, H, hd) with per-row offsets (the decode layout). Angles
    reach ~200 rad, where an ulp of the fp32 frequency moves cos/sin by
    ~2e-5: tolerance 1e-4."""
    x = _x(2 * 3 * 4, 64, 16).reshape(2, 3, 4, 64)
    pos = np.array([[0, 1, 2], [197, 198, 199]], np.int32)
    want = jlm._rope(jnp.asarray(x), jnp.asarray(pos))
    got = tlm._rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_kv_quantize_exact():
    t = _x(2 * 3 * 2, 64, 17).reshape(2, 3, 2, 64)
    wq, ws = jlm._kv_quantize(jnp.asarray(t))
    gq, gs = tlm._kv_quantize(torch.from_numpy(t))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# --------------------------------------------------------- default device

def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = tlm.ModelConfig(vocab_size=32, d_model=32, n_heads=2,
                          n_layers=1, d_ff=64)
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tlm.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.params_from_jax({"w": np.zeros(2, np.float32)})
    cpu = tlm.init_cache(cfg, 1, 8, device="cpu")
    assert cpu["k"].device.type == "cpu"
