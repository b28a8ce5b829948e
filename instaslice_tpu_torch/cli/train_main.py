"""The training entry point (port of ``instaslice_tpu/cli/train_main.py``,
``tpuslice-train``), on one card or one process per rank under
``torchrun``.

    python -m instaslice_tpu_torch.cli.train_main --synthetic 200000 \\
        --seq-len 1024 --global-batch 8 --steps 20
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m instaslice_tpu_torch.cli.train_main --synthetic 200000 \\
        --tp 2 --zero1

Streams batches from a memory-mapped token file (or a seeded synthetic
corpus), runs :func:`~instaslice_tpu_torch.models.train.make_train_step`
and checkpoints through
:class:`~instaslice_tpu_torch.models.checkpoint.TrainCheckpointer` with
bit-identical resume. On the card (``--device cuda``, the default) it
computes in bf16 over fp32 master weights (``--param-dtype same`` keeps
the weights in bf16); with ``--device cpu`` in fp32, as the reference
does off the TPU. It ends with the reference's JSON line, with
``"backend"`` naming the device.

``--lora-rank R`` trains only LoRA adapters (``--lora-alpha``,
``--lora-targets``) over a frozen base: the seeded init, or the params
of a full port checkpoint (``--base-checkpoint``; its optimizer state is
not kept), int8-quantized with ``--quantize-base`` (QLoRA). The
checkpoint then holds the adapter tree, which the server's ``--lora``
reads.

``--n-experts E`` trains the GShard top-2 mixture-of-experts model (the
expert width is ``--d-ff``), its loss carrying the router's load-balance
term; ``--remat full`` or ``dots`` rematerializes each block (``dots``
keeps its unbatched matmul outputs).

Under ``torchrun`` (``WORLD_SIZE`` set) each process joins the process
group (NCCL on the card, gloo with ``--device cpu``) and the step runs
over a ("data", "seq", "model") mesh: ``--tp`` ranks hold each model
shard (heads, FFN hidden dim, or with ``--n-experts`` a block of the
experts), ``--sp`` ranks each block of the sequence (with ``--ring``:
ring attention; ``seq_len + 1`` must divide by ``--sp``), ``data`` takes
the rest, ``--global-batch`` splits over ``data`` and each rank reads
only its rows; ``--zero1`` slices the AdamW moments over ``data``;
``--lora-rank`` trains the adapters over the base's shards. With
``--from-env`` the group comes from the node agent's handoff env
instead (``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``; the rendezvous at
``tcp://<first hostname>:$TPUSLICE_COORDINATOR_PORT``, default 8476),
torchrun's ``RANK``/``WORLD_SIZE`` where set, as the reference's
``_build_mesh`` does. Rank r takes card ``LOCAL_RANK mod cards``; where
more ranks than cards run on a host they share them over gloo (NCCL
takes one rank a card). Rank 0 prints the JSON line and writes the
checkpoints, which restore at any world size.

Dataset rows are ``seq_len + 1`` tokens wide, so the model runs at S =
seq_len + 1, which the flash kernels take as it is.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import sys
import tempfile
import time

log = logging.getLogger("instaslice_tpu_torch.train")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="instaslice_tpu_torch.cli.train_main")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--data", default="",
                     help="token file (.npy / .u16 / .u32 flat stream)")
    src.add_argument("--synthetic", type=int, default=0, metavar="N",
                     help="train on N random tokens (no dataset needed)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batches per optimizer update")
    ap.add_argument("--grad-clip", type=float, default=1.0,
                    help="global L2 gradient-norm clip (0 disables)")
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help=">0: linear warmup then cosine decay to 10%% "
                         "over --steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--n-heads", type=int, default=16)
    ap.add_argument("--n-kv-heads", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=16)
    ap.add_argument("--d-ff", type=int, default=8192)
    ap.add_argument("--vocab-size", type=int, default=32000)
    ap.add_argument("--n-experts", type=int, default=0)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention (0 = full causal)")
    ap.add_argument("--remat", default="none",
                    choices=("none", "dots", "full"))
    ap.add_argument("--ring", action="store_true",
                    help="ring attention over the seq axis (long context; "
                         "with --sp > 1)")
    ap.add_argument("--from-env", action="store_true",
                    help="the process group and mesh from the slice's "
                         "handoff env (TPU_* vars)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis size (heads/ffn/experts sharding)")
    ap.add_argument("--sp", type=int, default=1,
                    help="seq-axis size (ring attention)")
    ap.add_argument("--param-dtype", default="float32",
                    choices=["float32", "same"],
                    help="weight storage dtype on the card (float32 = "
                         "master weights; same = the bf16 compute dtype)")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help=">0: train only LoRA adapters of this rank over "
                         "a frozen base")
    ap.add_argument("--lora-alpha", type=float, default=16.0)
    ap.add_argument("--lora-targets", default="wq,wv",
                    help="comma-separated block weights to adapt")
    ap.add_argument("--base-checkpoint", default="",
                    help="LoRA: restore the frozen base from this full "
                         "port checkpoint dir (default: the seeded init)")
    ap.add_argument("--quantize-base", action="store_true",
                    help="LoRA: int8-quantize the frozen base (QLoRA)")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint dir (resume if it has one)")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--max-keep", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def _build_mesh(args, dev, backend=None):
    """The ("data", "seq", "model") mesh (``train_main.py:109-140``):
    ``--tp`` ranks on ``model``, ``--sp`` on ``seq``, the rest on
    ``data``, over the process group from torchrun's env or, with
    ``--from-env``, from the handoff env. None in a plain single
    process."""
    from instaslice_tpu_torch.parallel import (
        SliceTopology,
        initialize_distributed,
        slice_mesh,
    )

    torchrun = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if not (args.from_env or torchrun):
        if args.tp * args.sp > 1:
            raise SystemExit(f"--tp {args.tp} --sp {args.sp} needs "
                             f"{args.tp * args.sp} processes: run under "
                             "python -m torch.distributed.run or with "
                             "--from-env")
        return None
    topo = SliceTopology.from_env()
    world = (int(os.environ["WORLD_SIZE"]) if torchrun
             else topo.num_workers)
    if world % (args.tp * args.sp):
        raise SystemExit(f"{world} ranks not divisible by tp={args.tp} * "
                         f"sp={args.sp}")
    init = None
    if not torchrun:
        host = topo.hostnames[0] if topo.hostnames else "127.0.0.1"
        init = "tcp://{}:{}".format(
            host, os.environ.get("TPUSLICE_COORDINATOR_PORT", "8476"))
    initialize_distributed(topo, backend=backend, init_method=init,
                           device=dev)
    return slice_mesh(axes=("data", "seq", "model"),
                      axis_sizes=(-1, args.sp, args.tp), device=dev,
                      topo=topo)


def _lora_step(args, model, opts):
    """``make_lora_train_step`` over the frozen base the LoRA flags name
    (``train_main.py:208-280``); every rank builds the whole base from the
    seed (or the checkpoint) and keeps its shards."""
    from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer
    from instaslice_tpu_torch.models.lora import (
        LoraConfig,
        make_lora_train_step,
    )
    from instaslice_tpu_torch.models.quant import quantize_params

    if args.zero1:
        raise SystemExit("--zero1 has nothing to shard in a LoRA run (the "
                         "adapter moments are ~0.1% of the base); remove it")
    lcfg = LoraConfig(rank=args.lora_rank, alpha=args.lora_alpha,
                      targets=tuple(t for t in args.lora_targets.split(",")
                                    if t))
    base = model.init(args.seed, device=opts["device"])
    if args.base_checkpoint:
        # params only: the base run's AdamW moments (2x params) are
        # never kept, which would undo the LoRA memory win
        if not os.path.isdir(args.base_checkpoint) or TrainCheckpointer(
                args.base_checkpoint).restore_params(base) is None:
            raise SystemExit(f"--base-checkpoint {args.base_checkpoint} has "
                             "no restorable checkpoint")
    if args.quantize_base:
        base = quantize_params(base)
    return make_lora_train_step(model, base, lcfg, **opts)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.ring and (args.seq_len + 1) % max(args.sp, 1):
        # dataset rows are seq_len+1 wide and ring shards that dim over seq
        raise SystemExit(
            f"--ring shards (seq_len + 1) = {args.seq_len + 1} over "
            f"sp={args.sp}, which does not divide; use a seq-len of "
            f"(multiple of {args.sp}) - 1, e.g. "
            f"{args.sp * ((args.seq_len + 1) // args.sp) - 1}")

    import torch
    import torch.distributed as dist

    from instaslice_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    shared = False
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        # a rank a card, round robin: more local ranks than cards share
        # them, and NCCL refuses two ranks on one card, so their group
        # is gloo (collectives staged through host memory)
        cards = torch.cuda.device_count()
        shared = int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > cards
        dev = resolve_device(f"cuda:{int(os.environ['LOCAL_RANK']) % cards}")
    mesh = _build_mesh(args, dev, "gloo" if shared else None)
    rank = dist.get_rank() if mesh is not None else 0
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING)
    if shared:
        log.warning("%s local ranks share %d card(s): gloo process group",
                    os.environ["LOCAL_WORLD_SIZE"], torch.cuda.device_count())
    try:
        return _train(args, dev, mesh, rank)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args, dev, mesh, rank: int) -> int:
    import numpy as np
    import torch

    from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer
    from instaslice_tpu_torch.models.data import (
        HostShardedTokens,
        Prefetcher,
        TokenDataset,
        batch_for_step,
        write_token_file,
    )
    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
    from instaslice_tpu_torch.models.train import leaves, make_train_step
    from instaslice_tpu_torch.parallel.collectives import mesh_axes

    axes = mesh_axes(mesh)
    dp, sp, tp = axes.data.size, axes.seq.size, axes.model.size
    if args.global_batch % (dp * args.grad_accum):
        raise SystemExit(
            f"--global-batch {args.global_batch} must be divisible by the "
            f"data-parallel axis ({dp} = world size / tp {tp} / sp {sp}) "
            f"times --grad-accum {args.grad_accum}")
    on_card = dev.type == "cuda"
    cfg = ModelConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
        max_seq_len=args.seq_len + 1,
        dtype=torch.bfloat16 if on_card else torch.float32,
        # mixed precision on the card: bf16 compute, fp32 master weights
        param_dtype=(torch.float32 if on_card
                     and args.param_dtype == "float32" else None),
        n_experts=args.n_experts, window=args.window,
        ring_attention=args.ring, remat=args.remat != "none",
        remat_policy="dots" if args.remat == "dots" else "full",
    )
    # the fp32-output products (the unembedding) run on the tensor cores
    # in TF32: exact on the forward's bf16 operands; the backward rounds
    # the fp32 dlogits to TF32, at least as precise as the TPU's
    # default-precision fp32 matmul
    torch.backends.cuda.matmul.allow_tf32 = on_card
    model = TpuLM(cfg)
    opts = dict(learning_rate=args.lr, grad_accum=args.grad_accum,
                grad_clip=args.grad_clip, warmup_steps=args.warmup_steps,
                decay_steps=args.steps if args.warmup_steps else 0,
                device=dev)
    if args.lora_rank:
        init_fn, step_fn = _lora_step(args, model, dict(opts, mesh=mesh))
    else:
        init_fn, step_fn = make_train_step(model, mesh=mesh,
                                           zero1=args.zero1, **opts)

    data_path = args.data
    synthetic = bool(args.synthetic)
    if synthetic:
        # per-process file: two concurrent synthetic runs must not
        # rewrite a corpus the other has mapped
        data_path = os.path.join(
            tempfile.gettempdir(),
            f"isl-torch-synthetic-{args.seed}-{os.getpid()}.u16")
        rng = np.random.default_rng(args.seed)
        write_token_file(data_path, rng.integers(
            1, min(cfg.vocab_size, 65535), size=args.synthetic))
        log.info("synthetic corpus: %d tokens at %s", args.synthetic,
                 data_path)
    ckpt = None
    prefetch = None
    try:
        ds = TokenDataset(data_path, args.seq_len, seed=args.seed)
        state = init_fn(args.seed)
        if args.checkpoint:
            ckpt = TrainCheckpointer(args.checkpoint,
                                     max_to_keep=args.max_keep)
            if ckpt.restore(state) is not None:
                log.info("resumed from step %d", state.step)
        if mesh is None:
            def fetch(step):
                return batch_for_step(ds, step, args.global_batch, dev)
        else:
            # this rank's rows only; the step takes them as they are
            loader = HostShardedTokens(ds, args.global_batch, dp,
                                       axes.data.rank, args.grad_accum)

            def fetch(step):
                return loader.batch_for_step(step, dev)
            step_fn = functools.partial(step_fn, local=True)
        prefetch = Prefetcher(fetch, start_step=state.step)
        t0 = time.monotonic()
        tokens_done = 0
        last_loss = float("nan")
        logged = []
        try:
            for step, batch in prefetch:
                if step >= args.steps:
                    break
                state, loss = step_fn(state, batch)
                tokens_done += args.global_batch * args.seq_len
                if (step + 1) % args.log_every == 0 or \
                        step + 1 == args.steps:
                    last_loss = float(loss)   # sync point
                    logged.append([step + 1, last_loss])
                    log.info("step %d loss %.4f  %.0f tok/s", step + 1,
                             last_loss, tokens_done / max(
                                 time.monotonic() - t0, 1e-9))
                if ckpt is not None and (step + 1) % args.save_every == 0:
                    ckpt.save(state)
        except KeyboardInterrupt:
            log.info("interrupted at step %d; saving", state.step)
        if on_card:
            torch.cuda.synchronize(dev)
        wall = time.monotonic() - t0
        if ckpt is not None:
            ckpt.save(state)
    finally:
        if prefetch is not None:
            prefetch.close()
        if ckpt is not None:
            ckpt.close()
        if synthetic and os.path.exists(data_path):
            os.unlink(data_path)
    if rank:
        return 0
    lay = state.layout
    print(json.dumps({
        "metric": "train_tokens_per_sec",
        "value": round(tokens_done / max(wall, 1e-9), 1),
        "unit": "tokens/s",
        "steps": int(state.step),
        # None (JSON null), not NaN: a resumed run already at --steps
        # does no work, and bare NaN is invalid JSON
        "final_loss": (round(last_loss, 4)
                       if last_loss == last_loss else None),
        # [step, loss] of every logged step, unrounded
        "losses": logged,
        "params_m": round(sum(
            p.numel() * (lay.n_blocks(i) if lay is not None else 1)
            for i, p in enumerate(leaves(state.params))) / 1e6, 1),
        "mesh": {"data": dp, "seq": sp, "model": tp},
        "backend": dev.type,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
