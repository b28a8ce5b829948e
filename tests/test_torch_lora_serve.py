"""Multi-LoRA serving in the port (``serving/engine.py`` adapters,
``api_server.build_engine``'s ``--lora``, the adapter checkpoint format)
held against the JAX engine and against merged single-adapter engines
on the CPU.

Engines serve the same seeded fp32 weights (bridged to the port) and two
seeded adapters whose ``b`` is drawn nonzero. fp32 compute, so greedy
chains agree token for token: the batched engine against an engine
serving that adapter merged into its weights, and against the JAX engine
with the same adapters (logprobs within 1e-4). The server half trains
its adapters with the port's own CLI (``--lora-rank 4 --quantize-base``)
and serves them through ``build_engine`` over HTTP.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.cli import train_main
from instaslice_tpu_torch.models import lora as tlora
from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer
from instaslice_tpu_torch.models.lm import TpuLM
from instaslice_tpu_torch.models.train import leaf_paths, leaves
from instaslice_tpu_torch.serving import AdmissionRequest, ServingEngine
from instaslice_tpu_torch.serving import api_server
from torch_port_util import both_params, configs, numpy_params

ENGINE = dict(max_batch=4, max_len=96, prefill_len=8)
PROMPT = [5, 9, 3, 7, 11, 2, 40, 13, 6, 21]
TARGETS = ("w_out", "wq", "wv")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny models: one intra-op thread keeps parallel test workers
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_kernel_opt_in(monkeypatch):
    monkeypatch.setenv("TPUSLICE_QUANT_KERNEL", "1")
    monkeypatch.delenv("TPUSLICE_DECODE_KERNEL", raising=False)


def _numpy_adapter(cfg, seed, b_scale):
    rng = np.random.default_rng(seed)
    shapes = tlora._target_shapes(cfg)
    return {"blocks": {t: {
        "a": (rng.standard_normal(shapes[t][:2] + (4,))
              * shapes[t][1] ** -0.5).astype(np.float32),
        "b": (rng.standard_normal((shapes[t][0], 4, shapes[t][2]))
              * b_scale).astype(np.float32)} for t in TARGETS}}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs("fp32")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 0), quantize=False)
    nps = [_numpy_adapter(jcfg, 1, 0.05), _numpy_adapter(jcfg, 2, 0.1)]
    return {"cfg": (jcfg, tcfg), "trees": (jtree, ttree),
            "jads": [jax.tree.map(jnp.asarray, a) for a in nps],
            "tads": [bridge.params_from_jax(a, device="cpu") for a in nps]}


def _port(setup, adapters=True, **kw):
    return ServingEngine(TpuLM(setup["cfg"][1]), setup["trees"][1],
                         device="cpu", **dict(ENGINE, **kw),
                         lora_adapters=setup["tads"] if adapters else None)


def _jax(setup, **kw):
    return JaxEngine(JaxLM(setup["cfg"][0]), setup["trees"][0],
                     lora_adapters=setup["jads"], **dict(ENGINE, **kw))


def _snapshot(eng):
    return {s: (r.request_id, r.prompt, r.generated, r.logprobs)
            for s, r in sorted(eng.slots.items())}


# ------------------------------------------------------------- the engine

def test_batched_adapters_match_merged_engines_and_the_jax_engine(setup):
    """Base, adapter 1 and adapter 2 decode in ONE batch: each stream is
    token-identical to an engine serving that adapter merged, and to the
    JAX engine serving the same adapters; the burst admission (batched
    prefill over mixed adapters) gives the same streams."""
    eng, jeng = _port(setup), _jax(setup)
    rids = {a: eng.add_request(PROMPT, adapter=a) for a in (0, 1, 2)}
    jrids = {a: jeng.add_request(PROMPT, adapter=a) for a in (0, 1, 2)}
    assert rids == jrids
    got, want = eng.decode_block(6), jeng.decode_block(6)
    assert got == want
    for a in (0, 1, 2):
        lp = eng.slots[a].logprobs
        np.testing.assert_allclose(lp, jeng.slots[a].logprobs, atol=1e-4)
    assert len({tuple(v) for v in got.values()}) >= 2
    _, tcfg = setup["cfg"]
    for a in (0, 1, 2):
        params = setup["trees"][1] if a == 0 else tlora.merge_lora(
            setup["trees"][1], setup["tads"][a - 1], tcfg,
            tlora.LoraConfig(rank=4, targets=TARGETS))
        ref = ServingEngine(TpuLM(tcfg), params, device="cpu", **ENGINE)
        rr = ref.add_request(PROMPT)
        assert ref.decode_block(6)[rr] == got[rids[a]], f"adapter {a}"
    burst = _port(setup)
    brids = burst.add_requests([AdmissionRequest(PROMPT, adapter=a)
                                for a in (0, 1, 2)])
    assert burst.prefill_batches >= 1
    out = burst.decode_block(6)
    assert [out[r[0]] for r in brids] == [got[rids[a]] for a in (0, 1, 2)]
    assert eng.gathered_rounds == 1 and eng.fastpath_rounds == 0


def test_fast_path_when_the_slots_agree_and_the_gather_when_not(setup):
    """All live slots on one adapter (the base included): the
    single-adapter path runs (its counter) and the chains and logprobs
    equal the gathered path's bit for bit; mixed slots take the gather,
    and once they drain to one adapter the next round is fast again."""
    for aid in (1, 0):
        outs = []
        for fast in (True, False):
            eng = _port(setup, adapter_fastpath=fast)
            for _ in range(3):
                eng.add_request(PROMPT[:5], adapter=aid)
            eng.step()
            eng.decode_block(6)
            outs.append((_snapshot(eng), eng.fastpath_rounds,
                         eng.gathered_rounds))
        (a, fast_rounds, g0), (b, f0, gathered) = outs
        assert a == b
        assert (fast_rounds, g0, f0, gathered) == (2, 0, 0, 2)
    eng = _port(setup)
    for aid in (0, 1, 2):
        eng.add_request(PROMPT[:3], adapter=aid)
    eng.decode_block(4)
    assert (eng.fastpath_rounds, eng.gathered_rounds) == (0, 1)
    for slot in list(eng.slots):
        if eng._slot_adapter_host[slot] != 1:
            eng.evict_slot(slot)
    eng.decode_block(4)
    assert eng.fastpath_rounds == 1


def test_the_adapter_survives_preempt_and_resume(setup):
    oracle = _port(setup)
    rid = oracle.add_request(PROMPT, adapter=2)
    oracle.decode_block(9)
    want = list(oracle.slots[0].generated)
    eng = _port(setup)
    rid = eng.add_request(PROMPT, adapter=2)
    eng.decode_block(4)
    eng.preempt_slot(0)
    assert eng.parked[rid].adapter == 2
    eng.add_request([1, 2, 3])                  # a base request takes slot 0
    slot = eng.resume_request(rid)
    assert slot == 1 and eng._slot_adapter_host[slot] == 2
    assert int(eng.slot_adapter[slot]) == 2
    eng.decode_block(5)
    assert eng.slots[slot].generated == want
    assert (eng.fastpath_rounds, eng.gathered_rounds) == (1, 1)


def _export(src, rid):
    slot = next(s for s, r in src.slots.items() if r.request_id == rid)
    src.preempt_slot(slot)
    blob = json.loads(json.dumps(src.export_session(rid)))
    src.drop_parked(rid)
    return blob


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_adapter_sessions_cross_between_the_port_and_jax_engines(direction,
                                                                setup):
    """An adapter-2 session over an int8 KV cache: the blob carries its
    adapter, the other engine resumes it through adapter 2 and continues
    with the unmigrated JAX engine's greedy tokens."""
    oracle = _jax(setup, kv_quant=True)
    oracle.add_request(PROMPT, adapter=2)
    oracle.decode_block(11)
    want = list(oracle.slots[0].generated)
    port, jeng = _port(setup, kv_quant=True), _jax(setup, kv_quant=True)
    src, dst = (port, jeng) if direction == "port_to_jax" else (jeng, port)
    src.add_request([4, 4, 4], adapter=1)       # another adapter, slot 0
    rid = src.add_request(PROMPT, adapter=2)
    src.decode_block(5)
    blob = _export(src, rid)
    assert blob["adapter"] == 2
    assert blob["model"] == dst.model_signature()
    new = dst.import_session(blob)
    assert dst.parked[new].adapter == 2
    slot = dst.resume_request(new)
    assert dst._slot_adapter_host[slot] == 2
    dst.decode_block(6)
    assert list(dst.slots[slot].generated) == want


def test_adapter_requests_never_hit_nor_feed_the_radix_cache(setup):
    """The radix tree holds base-model KV only: an adapter request whose
    prompt the tree holds prefills every chunk (no hit, no miss
    counted), and a finishing adapter request inserts nothing, so a base
    request of its prompt afterwards misses and decodes as on a fresh
    engine."""
    eng = _port(setup, radix_cache=True)
    head = list(range(30, 54))                  # 3 granules of 8
    eng.add_request(head + [1])
    eng.finish_slot(0)
    assert eng.prefix_inserted == 1 and eng.radix.tokens_cached() == 24
    stats = (eng.prefix_hits, eng.prefix_misses, eng.prefix_inserted,
             eng.radix.node_count())
    chunks = eng.prefill_dispatches
    eng.add_request(head + [2], adapter=1)
    assert eng.prefill_dispatches - chunks == 4
    fresh = list(range(60, 90))
    eng.add_request(fresh, adapter=2)
    eng.decode_block(3)
    for slot in list(eng.slots):
        eng.finish_slot(slot)
    assert (eng.prefix_hits, eng.prefix_misses, eng.prefix_inserted,
            eng.radix.node_count()) == stats
    assert eng.radix.match(fresh, 24).length == 0
    assert eng.kv.used_blocks() == eng.radix.pool_blocks()
    rid = eng.add_request(fresh)
    assert eng.prefix_misses == stats[1] + 1
    ref = _port(setup)
    rr = ref.add_request(fresh)
    assert eng.decode_block(4)[rid] == ref.decode_block(4)[rr]


def test_engine_refuses_a_draft_a_bad_adapter_and_bad_names(setup):
    _, tcfg = setup["cfg"]
    with pytest.raises(ValueError, match="speculative"):
        _port(setup, draft_model=TpuLM(tcfg))
    with pytest.raises(ValueError, match="1:1"):
        _port(setup, lora_names=["only-one"])
    wide = _numpy_adapter(configs("fp32", n_kv_heads=4)[0], 3, 0.05)
    with pytest.raises(ValueError, match="do not fit"):
        ServingEngine(TpuLM(tcfg), setup["trees"][1], device="cpu",
                      lora_adapters=[bridge.params_from_jax(
                          wide, device="cpu")], **ENGINE)
    eng = _port(setup, lora_names=["a", "b"])
    assert eng.adapter_names == {"a": 1, "b": 2} and eng.n_adapters == 2
    with pytest.raises(ValueError, match="out of range"):
        eng.add_request([1, 2], adapter=3)
    with pytest.raises(ValueError, match="out of range"):
        _port(setup, adapters=False).add_request([1, 2], adapter=1)


# ------------------------------------------------------ checkpoint format

def test_checkpoints_carry_leaf_paths_and_old_ones_still_restore(setup,
                                                              tmp_path):
    """Each leaf's path is saved beside it; an adapter tree is rebuilt
    from the file alone; a checkpoint without paths (the earlier format)
    restores into a state by leaf order, and its tree is refused."""
    _, tcfg = setup["cfg"]
    model = TpuLM(tcfg)
    init_fn, _ = tlora.make_lora_train_step(
        model, model.init(0, device="cpu"), tlora.LoraConfig(rank=2),
        device="cpu")
    state = init_fn(3)
    ck = TrainCheckpointer(str(tmp_path / "new"))
    assert ck.save(state)
    tree = ck.load_tree()
    assert leaf_paths(tree) == ["blocks/wq/a", "blocks/wq/b",
                                "blocks/wv/a", "blocks/wv/b"]
    for a, b in zip(leaves(tree), leaves(state.params)):
        assert torch.equal(a, b.detach())
    # the earlier format: the same payload without "paths"
    old = TrainCheckpointer(str(tmp_path / "old"))
    old.save(state)
    path = old._path(0)
    payload = torch.load(path, weights_only=True)
    del payload["paths"]
    torch.save(payload, path)
    fresh = init_fn(9)
    assert old.restore(fresh) is fresh
    for a, b in zip(leaves(fresh.params), leaves(state.params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no leaf paths"):
        old.load_tree()
    other = tlora.make_lora_train_step(
        model, model.init(0, device="cpu"),
        tlora.LoraConfig(rank=2, targets=("wk", "wo")), device="cpu")[0](0)
    with pytest.raises(ValueError, match="do not match"):
        ck.restore(other)


# -------------------------------------------------------------- the server

DIMS = ["--device", "cpu", "--d-model", "64", "--n-heads", "2",
        "--n-layers", "2", "--d-ff", "128", "--vocab-size", "256"]
SERVE = DIMS + ["--max-len", "64", "--prefill-len", "8", "--max-batch", "4"]


def _train(dirname, *extra, seed=1, lora=True):
    """The port's training CLI writes a checkpoint into ``dirname``."""
    flags = DIMS + ["--synthetic", "4000", "--seq-len", "15",
                    "--global-batch", "2", "--steps", "2", "--lr", "3e-2",
                    "--seed", str(seed), "--checkpoint", str(dirname),
                    *extra]
    if lora:
        flags += ["--lora-rank", "4", "--quantize-base"]
    assert train_main.main(flags) == 0


@pytest.fixture(scope="module")
def cli_adapters(tmp_path_factory):
    root = tmp_path_factory.mktemp("adapters")
    for seed, name in ((1, "billing"), (2, "support")):
        _train(root / name, seed=seed)
    return root


def _post(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _build(*flags):
    return api_server.build_engine(
        api_server.build_parser().parse_args(SERVE + list(flags)))


def test_server_serves_two_cli_trained_adapters(cli_adapters, capsys):
    """Two ``--lora`` dirs written by the LoRA CLI (QLoRA): the engine
    keeps the base weights and names the adapters by basename; the
    server lists them, routes the ``adapter`` field (each request's
    prefill runs through its adapter id, whose logits differ from the
    others', and each answer equals the engine's own run of that
    adapter) and answers 400 for an unknown name. (The tiny random model
    repeats its input token with probability 1, so its tokens and
    logprobs cannot tell adapters apart; its logits can.)"""
    billing, support = cli_adapters / "billing", cli_adapters / "support"
    eng = _build("--quantize", "--lora", str(billing),
                 "--lora", f"{support}:8")
    assert eng.n_adapters == 2
    assert eng.adapter_names == {"billing": 1, "support": 2}
    assert eng.lora["scales"].tolist() == [0.0, 4.0, 2.0]
    assert eng.merged_adapter == ""
    base = _build("--quantize")
    for (pa, a), (pb, b) in zip(zip(leaf_paths(eng.params),
                                    leaves(eng.params)),
                                zip(leaf_paths(base.params),
                                    leaves(base.params))):
        assert pa == pb
        for x, y in ((a.q, b.q), (a.s, b.s)) if hasattr(a, "q") else \
                ((a, b),):
            assert torch.equal(x, y), pa
    prefills = []
    forward = eng._forward

    def logged(tokens, cache, lengths, *a, **kw):
        out = forward(tokens, cache, lengths, *a, **kw)
        if tokens.shape[1] > 1:
            prefills.append((kw["aidx"].tolist(), out[0][0, 0].clone()))
        return out

    eng._forward = logged
    srv = api_server.ApiServer(eng, host="127.0.0.1", port=0).start()
    prompt = [7, 3, 9, 21, 4, 4, 8, 100, 5]
    served = {}
    try:
        code, models = _post(srv.url, "/v1/models")
        assert code == 200
        assert [m["id"] for m in models["data"][1:]] == ["billing",
                                                         "support"]
        assert all(m["adapter"] for m in models["data"][1:])
        for name in (None, "billing", "support"):
            body = {"prompt": prompt, "max_tokens": 5, "logprobs": True}
            if name:
                body["adapter"] = name
            code, out = _post(srv.url, "/v1/completions", body)
            assert code == 200, out
            ch = out["choices"][0]
            served[name] = (ch["token_ids"], ch["logprobs"])
        code, out = _post(srv.url, "/v1/completions",
                          {"prompt": prompt, "adapter": "nope"})
        assert code == 400 and "unknown adapter" in out["error"]
        code, st = _post(srv.url, "/v1/stats")
        eng_st = st["engine"]
        assert eng_st["adapter_fastpath"] is True
        assert eng_st["fastpath_rounds"] > 0
    finally:
        srv.stop()
        eng._forward = forward
    # two chunks per prompt, each through the request's adapter id
    assert [a for a, _ in prefills] == [[0], [0], [1], [1], [2], [2]]
    first = [lg for _, lg in prefills[::2]]
    assert all(float((x - y).abs().max()) > 1e-3
               for i, x in enumerate(first) for y in first[i + 1:])
    for aid, name in enumerate((None, "billing", "support")):
        rid = eng.add_request(prompt, adapter=aid)
        eng.decode_block(4)
        req = next(r for r in eng.slots.values() if r.request_id == rid)
        assert (req.generated, req.logprobs) == served[name]
        eng.finish_slot(next(s for s, r in eng.slots.items()
                             if r.request_id == rid))


def test_one_lora_merges_into_the_weights(cli_adapters):
    """One ``--lora``: merged into the bf16 weights before any
    quantization, no runtime adapters, and a request naming it gets the
    reference's 400."""
    billing = cli_adapters / "billing"
    eng = _build("--lora", str(billing))
    assert eng.merged_adapter == "billing" and eng.n_adapters == 0
    assert eng.lora is None
    tree = TrainCheckpointer(str(billing)).load_tree()
    base = _build()
    want = tlora.merge_lora(base.params, tree, base.model.cfg,
                            tlora.LoraConfig(rank=4, targets=("wq", "wv")))
    for t in ("wq", "wv", "wk"):
        assert torch.equal(eng.params["blocks"][t], want["blocks"][t])
    assert not torch.equal(eng.params["blocks"]["wq"],
                           base.params["blocks"]["wq"])
    srv = api_server.ApiServer(eng, host="127.0.0.1", port=0).start()
    try:
        code, out = _post(srv.url, "/v1/completions",
                          {"prompt": [1, 2, 3], "adapter": "billing"})
    finally:
        srv.stop()
    assert code == 400 and "MERGED" in out["error"]


def test_lora_checkpoints_the_server_refuses(cli_adapters, tmp_path):
    """A full-model checkpoint, a checkpoint without leaf paths, two dirs
    of one basename, and adapters with a draft model are refused."""
    full = tmp_path / "full"
    _train(full, lora=False)
    with pytest.raises(SystemExit, match="not a LoRA adapter checkpoint"):
        _build("--lora", str(full))
    pathless = tmp_path / "pathless"
    _train(pathless)
    ck = TrainCheckpointer(str(pathless))
    payload = torch.load(ck._path(ck.latest_step()), weights_only=True)
    del payload["paths"]
    torch.save(payload, ck._path(ck.latest_step()))
    with pytest.raises(SystemExit, match="not a LoRA adapter checkpoint"):
        _build("--lora", str(pathless))
    twin = tmp_path / "twin" / "billing"
    _train(twin, seed=4)
    with pytest.raises(SystemExit, match="share the basename"):
        _build("--lora", str(cli_adapters / "billing"), "--lora", str(twin))
    with pytest.raises(ValueError, match="speculative"):
        _build("--lora", str(cli_adapters / "billing"),
               "--lora", str(cli_adapters / "support"),
               "--draft-n-layers", "1")


def test_cli_trains_over_a_base_checkpoint(tmp_path, capsys):
    """``--base-checkpoint``: a full port checkpoint's params are the
    frozen base (its optimizer state is not kept); a directory without
    one is refused."""
    _train(tmp_path / "base", lora=False)
    capsys.readouterr()
    _train(tmp_path / "lora", "--base-checkpoint", str(tmp_path / "base"))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 2 and np.isfinite(line["final_loss"])
    tree = TrainCheckpointer(str(tmp_path / "lora")).load_tree()
    assert sorted(tree["blocks"]) == ["wq", "wv"]
    with pytest.raises(SystemExit, match="no restorable checkpoint"):
        _train(tmp_path / "x", "--base-checkpoint", str(tmp_path / "none"))
