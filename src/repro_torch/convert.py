"""Carry a model's engine tables across from the JAX package.

The JAX engine uploads a trained model as nine device arrays
(``repro.kernels.ops.DeviceTables``).  Handed over as numpy arrays, the
same nine arrays build an engine here, so both packages can run the very
same tables:

    arrays = {name: np.asarray(getattr(jax_dev, name))
              for name in jax_dev._fields}
    engine = Engine.from_tables(engine_tables_from_arrays(
        arrays, n_subtrees=S, n_partitions=P, n_classes=C, device="cuda"))

The same goes for a live server's mid-stream state: the ten fields of a
JAX ``repro.kernels.tick_step.TickState``, as numpy arrays, become the
port's :class:`~repro_torch.kernels.tick_step.TickState`
(:func:`tick_state_from_arrays`), so both packages can step the very
same state.

An RWKV6 parameter tree (``repro.models.rwkv.param_defs`` materialised:
nested dicts of numpy arrays, stacked over the layers) becomes the
port's model (:func:`rwkv_params_from_arrays`), and a JAX decode cache
becomes the port's cache (:func:`rwkv_cache_from_arrays`), so the port
can decode from a state that JAX prefilled.  The transformer's tree
(dense, VLM and MoE) and KV cache cross the same way
(:func:`transformer_params_from_arrays`,
:func:`transformer_cache_from_arrays`), and so do Zamba2's
(:func:`zamba2_params_from_arrays`, :func:`zamba2_cache_from_arrays`)
and Whisper's parameters (:func:`whisper_params_from_arrays`).  A JAX
``TrainState`` (step, parameters and both moments) becomes the port's
(:func:`train_state_from_arrays`), so both trainers can start from the
very same state.

This module takes plain numpy, so it imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.inference import EngineTables
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import DEVICE_TABLE_DTYPES, DeviceTables
from repro_torch.kernels.tick_step import TickState


def engine_tables_from_arrays(
    arrays: dict[str, np.ndarray],
    *,
    n_subtrees: int,
    n_partitions: int,
    n_classes: int,
    device: "str | torch.device | None" = None,
) -> EngineTables:
    """Validate the nine ``DeviceTables`` arrays and upload them.

    Shapes must be consistent (``slot_*`` (S, k), ``thresholds``
    (S, k, T), ``leaf_lo``/``leaf_hi`` (S, L, k), ``leaf_action``/
    ``leaf_valid`` (S, L)) with S = ``n_subtrees``, and every array must
    already have the dtype the engine runs on (int32 or f32): a silent
    cast could change a threshold's bits.
    """
    missing = set(DEVICE_TABLE_DTYPES) - set(arrays)
    extra = set(arrays) - set(DEVICE_TABLE_DTYPES)
    if missing or extra:
        raise ValueError(f"need exactly the DeviceTables fields; missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")
    host = {name: np.asarray(arrays[name]) for name in DEVICE_TABLE_DTYPES}
    S, k, T = host["thresholds"].shape
    L = host["leaf_lo"].shape[1]
    shapes = {"slot_op": (S, k), "slot_field": (S, k), "slot_pred": (S, k),
              "slot_init": (S, k), "thresholds": (S, k, T),
              "leaf_lo": (S, L, k), "leaf_hi": (S, L, k),
              "leaf_action": (S, L), "leaf_valid": (S, L)}
    if S != n_subtrees:
        raise ValueError(f"tables hold {S} subtrees, n_subtrees={n_subtrees}")
    for name, dt in DEVICE_TABLE_DTYPES.items():
        a = host[name]
        want = np.dtype(str(dt).removeprefix("torch."))
        if a.shape != shapes[name] or a.dtype != want:
            raise ValueError(f"{name}: need {want} {shapes[name]}, got "
                             f"{a.dtype} {a.shape}")
    dev = resolve_device(device)
    tables = DeviceTables(**{name: torch.tensor(host[name], device=dev)
                             for name in DEVICE_TABLE_DTYPES})
    return EngineTables(dev=tables, n_subtrees=int(n_subtrees),
                        n_partitions=int(n_partitions),
                        n_classes=int(n_classes))


def tick_state_from_arrays(
    arrays: dict[str, np.ndarray],
    *,
    device: "str | torch.device | None" = None,
) -> TickState:
    """Validate the ten ``TickState`` arrays and upload them.

    ``acc`` must be f32 (N+1, k), ``seen`` int32 (N+1, k), ``bounds``
    int32 (N+1, P, 2) and the seven per-row fields int32 (N+1,), with
    one N+1 throughout.  No dtype is cast, as in
    :func:`engine_tables_from_arrays`.
    """
    fields = TickState._fields
    missing = set(fields) - set(arrays)
    extra = set(arrays) - set(fields)
    if missing or extra:
        raise ValueError(f"need exactly the TickState fields; missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")
    host = {name: np.asarray(arrays[name]) for name in fields}
    n1, k = host["acc"].shape
    P = host["bounds"].shape[1]
    for name in fields:
        a = host[name]
        want_dt = np.float32 if name == "acc" else np.int32
        want = ((n1, k) if name in ("acc", "seen")
                else (n1, P, 2) if name == "bounds" else (n1,))
        if a.shape != want or a.dtype != want_dt:
            raise ValueError(f"{name}: need {np.dtype(want_dt)} {want}, got "
                             f"{a.dtype} {a.shape}")
    dev = resolve_device(device)
    return TickState(**{name: torch.tensor(host[name], device=dev)
                        for name in fields})


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A copy of a numpy array on ``dev``; a bfloat16 array (``ml_dtypes``,
    as JAX hands it over) keeps its bits through an int16 view.  Always a
    copy: the KV cache is written in place, and JAX's arrays are
    read-only views of its own buffers."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.tensor(a, device=dev)


def _model_from_arrays(tree: dict, defs, build, what: str,
                       dev: torch.device):
    """``build(tree of tensors on dev)`` after checking that ``tree`` holds
    exactly the leaves of ``defs``, each a float32 array of the declared
    shape; nothing is cast."""
    from repro_torch.distributed.pspec import tree_items
    defs = dict(tree_items(defs))
    host = dict(tree_items(tree))
    if set(defs) != set(host):
        raise ValueError(f"need exactly the {what} parameters; missing "
                         f"{sorted(set(defs) - set(host))}, unexpected "
                         f"{sorted(set(host) - set(defs))}")
    for name, d in defs.items():
        a = np.asarray(host[name])
        if a.shape != d.shape or a.dtype != np.float32:
            raise ValueError(f"{name}: need float32 {d.shape}, got "
                             f"{a.dtype} {a.shape}")

    def up(node):
        if isinstance(node, dict):
            return {k: up(v) for k, v in node.items()}
        return _tensor(np.asarray(node), dev)

    return build(up(tree))


def rwkv_params_from_arrays(
    tree: dict,
    *,
    cfg: ArchConfig,
    device: "str | torch.device | None" = None,
):
    """The port's RWKV6 model over a JAX parameter tree.

    ``tree`` holds exactly the leaves of ``param_defs(cfg)`` (``embed``,
    ``layers.{ln1,ln2,tm.*,cm.*}`` stacked over layers, ``ln_f``,
    ``head``), each a float32 array of the declared shape; nothing is
    cast.
    """
    from repro_torch.models import rwkv
    return _model_from_arrays(tree, rwkv.param_defs(cfg),
                              lambda t: rwkv.RWKV6(cfg, t), "RWKV6",
                              resolve_device(device))


def transformer_params_from_arrays(
    tree: dict,
    *,
    cfg: ArchConfig,
    device: "str | torch.device | None" = None,
):
    """The port's dense, VLM or MoE transformer, MLA included, over a
    JAX parameter tree.

    ``tree`` holds exactly the leaves of ``transformer.param_defs(cfg)``
    (``embed``, ``layers.{ln1,ln2,attn.*}`` -- with MLA ``attn.{wq_a,
    q_norm,wq_b,wkv_a,kv_norm,wk_b,wv_b,wo}`` -- and ``layers.mlp.*`` or
    ``layers.moe.*`` stacked over layers, ``lead_layers.*`` before them
    where the MoE config has dense lead layers, ``ln_f``, and ``head``
    unless the embeddings are tied, ``img_proj`` for the VLM), each a
    float32 array of the declared shape; nothing is cast.
    """
    from repro_torch.models import transformer
    return _model_from_arrays(tree, transformer.param_defs(cfg),
                              lambda t: transformer.Transformer(cfg, t),
                              "transformer", resolve_device(device))


def zamba2_params_from_arrays(
    tree: dict,
    *,
    cfg: ArchConfig,
    device: "str | torch.device | None" = None,
):
    """The port's Zamba2 model over a JAX parameter tree.

    ``tree`` holds exactly the leaves of ``mamba2.param_defs(cfg)``
    (``embed``, ``mamba_layers.*`` stacked over layers, ``shared.{ln1,
    attn.*,ln2,mlp.*}``, ``ln_f``, ``head``), each a float32 array of the
    declared shape; nothing is cast.
    """
    from repro_torch.models import mamba2
    return _model_from_arrays(tree, mamba2.param_defs(cfg),
                              lambda t: mamba2.Zamba2(cfg, t), "Zamba2",
                              resolve_device(device))


def whisper_params_from_arrays(
    tree: dict,
    *,
    cfg: ArchConfig,
    device: "str | torch.device | None" = None,
):
    """The port's Whisper encoder-decoder over a JAX parameter tree.

    ``tree`` holds exactly the leaves of ``whisper.param_defs(cfg)``
    (``embed``, ``dec_pos``, ``enc_layers.{ln1,attn.*,ln2,mlp.*}`` and
    ``dec_layers.{ln1,attn.*,ln_x,xattn.*,ln2,mlp.*}`` stacked over
    layers, ``ln_enc``, ``ln_f``), each a float32 array of the declared
    shape; nothing is cast.
    """
    from repro_torch.models import whisper
    return _model_from_arrays(tree, whisper.param_defs(cfg),
                              lambda t: whisper.Whisper(cfg, t), "Whisper",
                              resolve_device(device))


def train_state_from_arrays(
    tree: dict,
    *,
    cfg: ArchConfig,
    device: "str | torch.device | None" = None,
):
    """The port's ``TrainState`` from a JAX one handed over as numpy:
    ``tree`` holds ``step`` (an int32 scalar), ``params`` (the model's
    parameter tree, which builds the model as the ``*_params_from_arrays``
    functions do), and ``mu`` and ``nu`` (float32 trees of the same
    leaves and shapes); nothing is cast."""
    from repro_torch.models import model_zoo
    from repro_torch.train.optimizer import TrainState
    if set(tree) != {"step", "params", "mu", "nu"}:
        raise ValueError(f"need exactly step, params, mu and nu; got "
                         f"{sorted(tree)}")
    step = np.asarray(tree["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step: need an int32 scalar, got {step.dtype} "
                         f"{step.shape}")
    dev = resolve_device(device)
    zoo = model_zoo.get_model(cfg)
    defs = zoo.param_defs(cfg)
    model = _model_from_arrays(tree["params"], defs,
                               lambda t: zoo.build(cfg, t), cfg.arch_id, dev)
    mu, nu = (_model_from_arrays(tree[name], defs, lambda t: t, name, dev)
              for name in ("mu", "nu"))
    return TrainState(step=_tensor(step, dev), params=model, mu=mu, nu=nu)


def rwkv_cache_from_arrays(
    tree: dict,
    *,
    cfg: ArchConfig,
    batch: int,
    device: "str | torch.device | None" = None,
) -> dict:
    """The port's RWKV6 decode cache from a JAX one: ``tm.shift`` and
    ``cm.shift`` (L, batch, D) bfloat16, ``tm.S`` (L, batch * H, hd, hd)
    float32; nothing is cast."""
    from repro_torch.models.layers import COMPUTE_DTYPE
    dev = resolve_device(device)
    H, hd = cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
    Ln, D = cfg.n_layers, cfg.d_model
    want = {("tm", "shift"): (Ln, batch, D), ("tm", "S"): (Ln, batch * H, hd,
                                                           hd),
            ("cm", "shift"): (Ln, batch, D)}
    if set(tree) != {"tm", "cm"} or set(tree["tm"]) != {"shift", "S"} \
            or set(tree["cm"]) != {"shift"}:
        raise ValueError("need exactly tm.shift, tm.S and cm.shift")
    out: dict = {"tm": {}, "cm": {}}
    for (grp, name), shape in want.items():
        a = np.asarray(tree[grp][name])
        if a.shape != shape:
            raise ValueError(f"{grp}.{name}: need {shape}, got {a.shape}")
        want_dt = torch.float32 if name == "S" else COMPUTE_DTYPE
        t = _tensor(a, dev)
        if t.dtype != want_dt:
            raise ValueError(f"{grp}.{name}: need {want_dt}, got {a.dtype}")
        out[grp][name] = t
    return out


def transformer_cache_from_arrays(
    tree: dict,
    *,
    cfg: ArchConfig,
    batch: int,
    device: "str | torch.device | None" = None,
) -> dict:
    """The port's KV cache from a JAX one: ``layers.k`` and ``layers.v``
    (L, batch, S, Hkv, Dh) bfloat16, nothing cast, and ``layers.len``,
    JAX's (L,) int32 per-layer lengths, which must all be equal and at
    most S: they become the cache's one host length."""
    from repro_torch.models.layers import COMPUTE_DTYPE
    dev = resolve_device(device)
    if set(tree) != {"layers"}:
        raise ValueError("need exactly layers.k, layers.v and layers.len")
    lay = tree["layers"]
    S = np.asarray(lay["k"]).shape[2] if np.ndim(lay.get("k")) == 5 else -1
    return {"layers": _kv_from_arrays(
        lay, "layers", (cfg.n_layers, batch, S, cfg.n_kv_heads,
                        cfg.head_dim), COMPUTE_DTYPE, dev)}


def _kv_from_arrays(kv: dict, what: str, want: tuple, dtype: torch.dtype,
                    dev: torch.device) -> dict:
    """Stacked ``k``, ``v`` (n, batch, S, Hkv, Dh) of the shape ``want``
    and ``dtype``, nothing cast, and JAX's (n,) int32 lengths, which must
    all be equal and at most S: they become one host length."""
    if set(kv) != {"k", "v", "len"}:
        raise ValueError(f"need exactly {what}.k, {what}.v and {what}.len")
    out: dict = {}
    for name in ("k", "v"):
        a = np.asarray(kv[name])
        if a.shape != want:
            raise ValueError(f"{what}.{name}: need {want}, got {a.shape}")
        t = _tensor(a, dev)
        if t.dtype != dtype:
            raise ValueError(f"{what}.{name}: need {dtype}, got {a.dtype}")
        out[name] = t
    n, S = want[0], want[2]
    lens = np.asarray(kv["len"])
    if lens.shape != (n,) or lens.dtype != np.int32:
        raise ValueError(f"{what}.len: need int32 ({n},), got {lens.dtype} "
                         f"{lens.shape}")
    if lens.min() != lens.max() or not 0 <= int(lens[0]) <= S:
        raise ValueError(f"{what}.len: need one length in [0, {S}] for "
                         f"every layer, got {lens.tolist()}")
    out["len"] = int(lens[0])
    return out


def zamba2_cache_from_arrays(
    tree: dict,
    *,
    cfg: ArchConfig,
    batch: int,
    device: "str | torch.device | None" = None,
) -> dict:
    """The port's Zamba2 cache from a JAX one: ``mamba.conv`` (L, batch,
    conv_dim - 1, C) bfloat16 and ``mamba.S`` (L, batch * H, N, hd)
    float32, nothing cast; ``attn.k`` and ``attn.v`` (G, batch, S, Hkv,
    Dh) bfloat16 (``mamba2.KV_DTYPE``) and ``attn.len``, JAX's (G,)
    int32 per-group lengths, which must all be equal: they become the
    cache's one host length."""
    from repro_torch.models import mamba2
    from repro_torch.models.layers import COMPUTE_DTYPE
    dev = resolve_device(device)
    if set(tree) != {"mamba", "attn"} or set(tree["mamba"]) != {"conv",
                                                                  "S"}:
        raise ValueError("need exactly mamba.conv, mamba.S and attn")
    s = cfg.ssm
    _, H, conv_ch = mamba2._dims(cfg)
    Ln = cfg.n_layers
    out: dict = {"mamba": {}}
    for name, shape, dt in (
            ("conv", (Ln, batch, s.conv_dim - 1, conv_ch), COMPUTE_DTYPE),
            ("S", (Ln, batch * H, s.state_dim, s.head_dim), torch.float32)):
        a = np.asarray(tree["mamba"][name])
        if a.shape != shape:
            raise ValueError(f"mamba.{name}: need {shape}, got {a.shape}")
        t = _tensor(a, dev)
        if t.dtype != dt:
            raise ValueError(f"mamba.{name}: need {dt}, got {a.dtype}")
        out["mamba"][name] = t
    if not cfg.shared_attn_every:
        if tree["attn"] is not None:
            raise ValueError("attn: need None without a shared block")
        out["attn"] = None
        return out
    kv = tree["attn"]
    G = Ln // cfg.shared_attn_every
    S = np.asarray(kv["k"]).shape[2] if np.ndim(kv.get("k")) == 5 else -1
    out["attn"] = _kv_from_arrays(
        kv, "attn", (G, batch, S, cfg.n_kv_heads, cfg.head_dim),
        mamba2.KV_DTYPE, dev)
    return out
