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
computes them outside any Pallas kernel. ``lora_specs`` (the adapter
tree's sharding over a device mesh) has no meaning on one card and is
not ported, as the train step has no mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from instaslice_tpu_torch import resolve_device
from instaslice_tpu_torch.models.lm import ModelConfig, _generator
from instaslice_tpu_torch.models.quant import QUANT_TYPES, weight

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


def merge_lora(params: Params, lora: Params, cfg: ModelConfig,
               lcfg: LoraConfig) -> Params:
    """Base params with every adapted leaf replaced by ``weight(w) +
    scale · a @ b`` in ``cfg.dtype`` (an int8 or int4 base dequantizes
    here: QLoRA). The products and the sum are fp32, as the reference's
    ``preferred_element_type=float32``. Differentiable in ``lora``; the
    other leaves are the base's own objects, and the returned tree feeds
    the unmodified forward and loss."""
    merged = dict(params)
    merged["blocks"] = dict(params["blocks"])
    for t, ab in lora["blocks"].items():
        w = weight(params["blocks"][t], cfg.dtype)
        delta = torch.einsum("lir,lro->lio", ab["a"].float(),
                             ab["b"].float()) * lcfg.scale
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
) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` training ONLY the adapter tree on one card
    (``lora.py:214-293`` without the mesh).

    ``base_params`` is captured frozen on the device (its leaves may be
    int8). ``init_fn(seed=0, lora=None) -> TrainState`` holds the
    adapters (:func:`init_lora` from ``seed``, or the given tree moved to
    the device) and their optimizer: the port's
    :class:`~instaslice_tpu_torch.models.train.Optimizer` at
    ``weight_decay=0.0`` (decaying A/B would shrink the delta toward the
    base). ``step_fn(state, tokens) -> (state, loss)`` takes the
    existing ``loss_fn`` over :func:`merge_lora` of the base and the
    adapters, through the shared ``accumulated_grads``; ``grad_accum``,
    ``grad_clip`` and the warmup-cosine schedule behave as in
    ``make_train_step``."""
    from instaslice_tpu_torch.models.train import (
        Optimizer,
        TrainState,
        accumulated_grads,
        leaves,
        loss_fn,
    )

    cfg = model.cfg
    dev = resolve_device(device)
    base = frozen(base_params, dev)

    def init_fn(seed: Union[int, torch.Generator] = 0,
                lora: Optional[Params] = None) -> TrainState:
        if lora is None:
            lora = init_lora(seed, cfg, lcfg, device=dev)
        else:   # a copy: the step updates its leaves in place
            lora = {"blocks": {t: {k: v.clone() for k, v in ab.items()}
                               for t, ab in frozen(lora, dev)["blocks"]
                               .items()}}
        for p in leaves(lora):
            p.requires_grad_(True)
        opt = Optimizer(leaves(lora), learning_rate, grad_clip=grad_clip,
                        warmup_steps=warmup_steps, decay_steps=decay_steps,
                        weight_decay=0.0)
        return TrainState(step=0, params=lora, opt_state=opt)

    def loss_of(lora, toks):
        return loss_fn(model, merge_lora(base, lora, cfg, lcfg), toks,
                       loss_chunk=loss_chunk)

    def step_fn(state: TrainState, tokens: torch.Tensor):
        tokens = torch.as_tensor(tokens).to(dev)
        loss = accumulated_grads(loss_of, state.params, tokens, grad_accum)
        state.opt_state.step()
        state.step += 1
        return state, loss

    return init_fn, step_fn
