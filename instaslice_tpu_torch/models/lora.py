"""LoRA: low-rank adapters over a frozen base model (port of
``instaslice_tpu/models/lora.py``).

As in the JAX package:

- adapters are **merged, not injected** for training:
  :func:`make_lora_train_step` computes ``w + (alpha/rank) · A @ B`` per
  target (:func:`merge_lora`) and runs the unmodified forward, so the
  flash-attention kernels (B5 forward, B6 and B7 backward) run inside
  the step as in full training;
- **only the adapters train**: gradients reach ``A``/``B`` through the
  merge (autograd), the base is a frozen capture (``requires_grad``
  False) and the AdamW moments exist for the adapter tree only;
- **QLoRA for free**: a :class:`~instaslice_tpu_torch.models.quant.
  QuantizedTensor` base leaf dequantizes inside the merge, and the
  leaves the adapters do not target stay int8 and dequantize one layer
  at a time inside the forward (:func:`~instaslice_tpu_torch.models.lm.
  apply`);
- ``B`` starts at zero, so a LoRA run's first loss is the frozen-base
  loss;
- over a mixture-of-experts base only the attention projections take
  adapters (the expert stacks are 4-D), and the loss carries the
  router's load-balance term, as full training does;
- serving: one adapter merges into the weights once (:func:`merge_lora`);
  several serve batched (:func:`stack_adapters`, the per-row deltas of
  :func:`~instaslice_tpu_torch.models.lm.apply_with_cache`).

The deltas are plain ``torch.einsum`` products, as the JAX package
computes them outside any Pallas kernel. Under a mesh (``mesh=`` of
:func:`make_lora_train_step`) the adapter tree is laid out by
:func:`lora_specs` and each rank merges its shards of the base
(:func:`merge_lora` with ``axes``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from instaslice_tpu_torch import resolve_device
from instaslice_tpu_torch.models.lm import (
    ModelConfig,
    _generator,
    param_specs,
)
from instaslice_tpu_torch.models.quant import (
    QUANT_TYPES,
    shard_params,
    weight,
)
from instaslice_tpu_torch.parallel.collectives import (
    NO_MESH,
    MeshAxes,
    copy_to,
    mesh_axes,
    shard,
)

Params = Dict[str, Any]

#: targets that are plain (L, in, out) stacked dense weights in
#: init_params' tree: the shapes LoRA's two-matrix factorization fits
_DENSE_TARGETS = ("wq", "wk", "wv", "wo", "w_in", "w_out")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    #: which block weights get adapters; ("wq", "wv") is the classic
    #: LoRA-paper attention choice, all six approach full fine-tuning
    targets: Tuple[str, ...] = ("wq", "wv")

    def __post_init__(self) -> None:
        if self.rank <= 0:
            raise ValueError(f"rank={self.rank} must be positive")
        if not self.targets:
            raise ValueError(
                "targets is empty — a LoRA run with no adapters would "
                "train nothing and silently checkpoint an empty tree")
        bad = [t for t in self.targets if t not in _DENSE_TARGETS]
        if bad:
            raise ValueError(
                f"unsupported LoRA targets {bad} (supported: "
                f"{_DENSE_TARGETS}; MoE expert weights are not)")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _target_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int, int]]:
    """(L, fan_in, fan_out) for each adaptable stacked weight."""
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    K = cfg.n_heads * cfg.head_dim
    Kkv = cfg.kv_heads * cfg.head_dim
    shapes = {"wq": (L, D, K), "wk": (L, D, Kkv), "wv": (L, D, Kkv),
              "wo": (L, K, D)}
    if not cfg.n_experts:
        shapes["w_in"] = (L, D, F)
        shapes["w_out"] = (L, F, D)
    return shapes


def init_lora(seed: Union[int, torch.Generator], cfg: ModelConfig,
              lcfg: LoraConfig, *, device="cuda") -> Params:
    """Adapter tree ``{"blocks": {t: {"a": (L, in, r), "b": (L, r, out)}}}``
    in fp32, targets in sorted order: ``a`` is N(0, 1) · fan_in**-0.5
    from a torch generator (the draws differ from ``jax.random``'s; move
    the JAX package's adapters with :mod:`instaslice_tpu_torch.bridge`
    where the two must agree), ``b`` is zero, so the merged model starts
    exactly at the base model."""
    shapes = _target_shapes(cfg)
    missing = [t for t in lcfg.targets if t not in shapes]
    if missing:
        raise ValueError(
            f"targets {missing} not adaptable for this config "
            f"(MoE models only adapt attention: {list(shapes)})")
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    blocks = {}
    for t in sorted(lcfg.targets):
        L, fin, fout = shapes[t]
        blocks[t] = {
            "a": torch.randn((L, fin, lcfg.rank), generator=gen,
                             dtype=torch.float32, device=dev) * fin ** -0.5,
            "b": torch.zeros((L, lcfg.rank, fout), dtype=torch.float32,
                             device=dev),
        }
    return {"blocks": blocks}


def lora_specs(cfg: ModelConfig, lcfg: LoraConfig) -> Params:
    """The adapter tree's layout over a mesh (``lora.py:127-141``):
    ``b``'s output dim follows the base weight's output axis (``model``
    for the column-parallel ``wq``/``wk``/``wv`` and dense ``w_in``), ``a``
    is replicated, and so is ``b`` of the row-parallel ``wo`` and dense
    ``w_out``."""
    base = param_specs(cfg)["blocks"]
    return {"blocks": {t: {"a": (None, None, None),
                           "b": (None, None, base[t][-1])}
                       for t in sorted(lcfg.targets)}}


def merge_lora(params: Params, lora: Params, cfg: ModelConfig,
               lcfg: LoraConfig, axes: MeshAxes = NO_MESH) -> Params:
    """Base params with every adapted leaf replaced by ``weight(w) +
    scale · a @ b`` in ``cfg.dtype`` (an int8 or int4 base dequantizes
    here: QLoRA). The products and the sum are fp32, as the reference's
    ``preferred_element_type=float32``. Differentiable in ``lora``; the
    other leaves are the base's own objects, and the returned tree feeds
    the unmodified forward and loss.

    Under a ``model`` axis ``params`` are this rank's shards and ``lora``
    is laid out by :func:`lora_specs`; each merge is built on shards: a
    column-parallel target takes ``a @ b`` with ``b`` its columns, a
    row-parallel one ``a[rank's rows] @ b``. The replicated leaves a rank
    reads only in part (``a`` of every target, ``b`` of the row-parallel
    ones) enter through :func:`copy_to`, so their gradients, partial on
    each rank, are summed over ``model``."""
    tp = axes.model
    specs = param_specs(cfg)["blocks"]
    merged = dict(params)
    merged["blocks"] = dict(params["blocks"])
    for t, ab in lora["blocks"].items():
        w = weight(params["blocks"][t], cfg.dtype)
        a, b = ab["a"], ab["b"]
        if tp.size > 1:
            a = copy_to(a, tp)
            if specs[t][-2] == "model":
                a = shard(a, tp, 1)
                b = copy_to(b, tp)
        delta = torch.einsum("lir,lro->lio", a.float(), b.float()) \
            * lcfg.scale
        merged["blocks"][t] = (w.float() + delta).to(cfg.dtype)
    return merged


def stack_adapters(adapters, cfg: ModelConfig, alphas=None) -> Params:
    """Stack adapter trees for multi-LoRA serving: ``{"blocks": {t: {"a":
    (L, N+1, in, r), "b": (L, N+1, r, out)}}, "scales": (N+1,)}`` with an
    ALL-ZERO adapter at index 0, so "no adapter" rows get an exactly-zero
    delta through the same forward. Every adapter must share rank and
    targets; ``alphas`` defaults to 16.0 each and ``scales`` is ``[0] +
    alpha / rank``. The layer axis leads, as the base weights'."""
    if not adapters:
        raise ValueError("need at least one adapter to stack")
    first = adapters[0]["blocks"]
    targets = tuple(sorted(first))
    rank = int(first[targets[0]]["a"].shape[-1])
    for i, ad in enumerate(adapters):
        if tuple(sorted(ad["blocks"])) != targets:
            raise ValueError(
                f"adapter {i} targets {sorted(ad['blocks'])} != "
                f"{list(targets)} — one static stack needs one target "
                "set; retrain or serve separately")
        r = int(ad["blocks"][targets[0]]["a"].shape[-1])
        if r != rank:
            raise ValueError(
                f"adapter {i} rank {r} != {rank} — one static stack "
                "needs one rank")
    if alphas is None:
        alphas = [16.0] * len(adapters)
    if len(alphas) != len(adapters):
        raise ValueError("alphas must match adapters 1:1")
    blocks = {}
    for t in targets:
        blocks[t] = {
            k: torch.stack([torch.zeros_like(first[t][k])]
                           + [ad["blocks"][t][k] for ad in adapters], dim=1)
            for k in ("a", "b")
        }
    scales = torch.tensor([0.0] + [float(al) / rank for al in alphas],
                          dtype=torch.float32,
                          device=first[targets[0]]["a"].device)
    return {"blocks": blocks, "scales": scales}


def frozen(tree, dev: torch.device):
    """A params or adapter tree on ``dev`` with every tensor detached (no
    grad; no copy where it is there already); int8 and int4 leaves stay
    quantized, nothing is dequantized."""
    if isinstance(tree, dict):
        return {k: frozen(v, dev) for k, v in tree.items()}
    if isinstance(tree, QUANT_TYPES):
        return tree.to(dev)
    return tree.detach().to(dev)


def make_lora_train_step(
    model,
    base_params: Params,
    lcfg: LoraConfig,
    *,
    learning_rate: float = 1e-4,
    loss_chunk: int = 512,
    grad_clip: float = 1.0,
    grad_accum: int = 1,
    warmup_steps: int = 0,
    decay_steps: int = 0,
    device="cuda",
    mesh=None,
) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` training ONLY the adapter tree
    (``lora.py:214-293``), on one card or, with ``mesh``, SPMD over a
    ("data", "seq", "model") ``DeviceMesh``.

    ``base_params`` (the whole tree; its leaves may be int8) is captured
    frozen on the device, under a mesh as this rank's shards
    (:func:`~instaslice_tpu_torch.models.quant.shard_params`, int8 values
    and scales split alike). ``init_fn(seed=0, lora=None) -> TrainState``
    holds the adapters (:func:`init_lora` from ``seed``, or the given
    tree moved to the device; under a mesh this rank's block by
    :func:`lora_specs`) and their optimizer: the port's
    :class:`~instaslice_tpu_torch.models.train.Optimizer` at
    ``weight_decay=0.0`` (decaying A/B would shrink the delta toward the
    base). ``step_fn(state, tokens, *, local=False) -> (state, loss)``
    takes the existing ``loss_fn`` over :func:`merge_lora` of the base and
    the adapters, through the shared ``accumulated_grads``; under a mesh
    each rank takes its ``data`` rows and the adapters' gradients (whole
    on each rank after the merge's ``copy_to``) average over ``data``
    before the clip, whose norm counts ``b``'s column shards over
    ``model``. ``grad_accum``, ``grad_clip`` and the warmup-cosine
    schedule behave as in ``make_train_step``."""
    from instaslice_tpu_torch.models.data import data_rows
    from instaslice_tpu_torch.models.lm import check_mesh
    from instaslice_tpu_torch.models.train import (
        Layout,
        Optimizer,
        TrainState,
        accumulated_grads,
        average_grads,
        leaves,
        loss_fn,
        map_tree,
    )

    cfg = model.cfg
    dev = resolve_device(device)
    axes = mesh_axes(mesh)
    check_mesh(cfg, axes)
    base = frozen(base_params, dev)
    if mesh is not None:
        base = shard_params(base, param_specs(cfg), axes)
    specs = lora_specs(cfg, lcfg)

    def init_fn(seed: Union[int, torch.Generator] = 0,
                lora: Optional[Params] = None) -> TrainState:
        if lora is None:
            lora = init_lora(seed, cfg, lcfg, device=dev)
        else:   # a copy: the step updates its leaves in place
            lora = {"blocks": {t: {k: v.clone() for k, v in ab.items()}
                               for t, ab in frozen(lora, dev)["blocks"]
                               .items()}}
        layout = None
        if mesh is not None:
            layout = Layout(cfg, axes, lora, specs=specs)
            lora = map_tree(
                lambda path, t: layout.shard(layout.paths.index(path), t),
                lora)
        for p in leaves(lora):
            p.requires_grad_(True)
        opt = Optimizer(leaves(lora), learning_rate, grad_clip=grad_clip,
                        warmup_steps=warmup_steps, decay_steps=decay_steps,
                        weight_decay=0.0, layout=layout)
        return TrainState(step=0, params=lora, opt_state=opt, layout=layout)

    def loss_of(lora, toks):
        return loss_fn(model, merge_lora(base, lora, cfg, lcfg, axes), toks,
                       mesh, loss_chunk=loss_chunk)

    def step_fn(state: TrainState, tokens: torch.Tensor, *,
                local: bool = False):
        tokens = torch.as_tensor(tokens).to(dev)
        dp = axes.data
        if dp.size > 1 and not local:
            rows = data_rows(tokens.shape[0], dp.size, dp.rank, grad_accum)
            tokens = tokens[torch.tensor(rows, device=dev)]
        loss = accumulated_grads(loss_of, state.params, tokens, grad_accum)
        loss = average_grads(state.params, loss, axes)
        state.opt_state.step()
        state.step += 1
        return state, loss

    return init_fn, step_fn
