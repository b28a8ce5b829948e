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
shard, ``data`` takes the rest, ``--global-batch`` splits over ``data``
and each rank reads only its rows; ``--zero1`` slices the AdamW moments
over ``data``. Rank 0 prints the JSON line and writes the checkpoints,
which restore at any world size.

Flags of the reference that the port does not run yet exit non-zero
and name their ROADMAP queue-A item: ``--ring``, ``--sp`` > 1,
``--from-env``, ``--n-experts`` with ``--tp`` > 1, and ``--lora-rank``
at a world size above 1.
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
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--from-env", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
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


def _refuse_unported(args, world: int) -> None:
    """Exit non-zero on a flag whose path is not ported yet."""
    unported = [
        (args.ring, "--ring", "ring attention"),
        (args.sp > 1, "--sp > 1", "ring attention"),
        (args.from_env, "--from-env", "multi-host training"),
        (args.n_experts and args.tp > 1, "--n-experts with --tp > 1",
         "MoE experts over the model axis"),
        (args.lora_rank and world > 1, "--lora-rank at world size > 1",
         "LoRA/QLoRA under a mesh"),
    ]
    for hit, flag, item in unported:
        if hit:
            raise SystemExit(f"{flag} is not ported yet ({item}: ROADMAP "
                             "queue A, training)")


def _build_mesh(args, dev):
    """The ("data", "seq", "model") mesh under torchrun
    (``train_main.py:109-140``): the process group from torchrun's env,
    ``--tp`` ranks on ``model``, the rest on ``data``. None in a plain
    single process."""
    if "WORLD_SIZE" not in os.environ:
        if args.tp > 1:
            raise SystemExit(f"--tp {args.tp} needs {args.tp} processes: "
                             "run under python -m torch.distributed.run")
        return None
    from instaslice_tpu_torch.parallel import (
        initialize_distributed,
        slice_mesh,
    )

    world = int(os.environ["WORLD_SIZE"])
    if world % args.tp:
        raise SystemExit(f"--tp {args.tp} does not divide the world size "
                         f"{world}")
    initialize_distributed(device=dev)
    return slice_mesh(axis_sizes=(-1, 1, args.tp), device=dev)


def _lora_step(args, model, opts):
    """``make_lora_train_step`` over the frozen base the LoRA flags name
    (``train_main.py:208-280``)."""
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
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING)
    _refuse_unported(args, world)

    import torch.distributed as dist

    from instaslice_tpu_torch import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = resolve_device(f"cuda:{os.environ['LOCAL_RANK']}")
    # LoRA runs on one process (a larger world was refused above)
    mesh = None if args.lora_rank else _build_mesh(args, dev)
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
    dp, tp = axes.data.size, axes.model.size
    if args.global_batch % (dp * args.grad_accum):
        raise SystemExit(
            f"--global-batch {args.global_batch} must be divisible by the "
            f"data-parallel axis ({dp} = world size / tp {tp}) times "
            f"--grad-accum {args.grad_accum}")
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
        remat=args.remat != "none",
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
        init_fn, step_fn = _lora_step(args, model, opts)
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
            p.numel() * (tp if lay is not None and lay.model_sharded(i)
                         else 1)
            for i, p in enumerate(leaves(state.params))) / 1e6, 1),
        "mesh": {"data": dp, "seq": 1, "model": tp},
        "backend": dev.type,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
