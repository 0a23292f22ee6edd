"""Shared config -> object factories for the port's CLI entry points.

Counterpart of :mod:`dpr_scale_tpu.cli.common`: the dense task (the CLS
bi-encoder, or SPLADE with ``task.model.family=splade``), the multi-vector
task (``task.type=multivec``) and the distillation task
(``task.type=distill``). The encode / retrieve / serve CLIs build the model
of ``task.model.family`` (:func:`build_biencoder`), as the JAX CLIs do
through their task. The tokenizer and the datamodules are the port's copies
of the JAX package's (``dpr_scale_tpu_torch.data``); batches come out as
numpy and the task copies them to its device.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from dpr_scale_tpu_torch.data.datamodule import DenseRetrieverDataModule, DistillDataModule
from dpr_scale_tpu_torch.data.tokenize import HFTokenizer
from dpr_scale_tpu_torch.models.convert import init_params
from dpr_scale_tpu_torch.models.encoder import BiEncoder, SpladeBiEncoder
from dpr_scale_tpu_torch.models.transformer import TransformerConfig
from dpr_scale_tpu_torch.optim.factory import make_optimizer
from dpr_scale_tpu_torch.train.checkpoint import load_params
from dpr_scale_tpu_torch.train.distill import DPRDistillTask
from dpr_scale_tpu_torch.train.multivec import MultiVecRetrieverTask
from dpr_scale_tpu_torch.train.schedule import linear_warmup_decay
from dpr_scale_tpu_torch.train.task import DenseRetrieverTask

ARCH_PRESETS = {
    "tiny": TransformerConfig.tiny,
    "bert_base": TransformerConfig.bert_base,
    "bert_large": TransformerConfig.bert_large,
    "roberta_base": TransformerConfig.roberta_base,
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_tokenizer(cfg) -> HFTokenizer:
    t = cfg.task.transform
    return HFTokenizer(
        t.model_path,
        max_seq_len=t.get("max_seq_len", 256),
        pad_to_multiple=t.get("pad_to_multiple", 0),
    )


def build_model_config(cfg) -> TransformerConfig:
    m = cfg.task.model
    base = ARCH_PRESETS[m.get("arch", "bert_base")]()
    overrides = {
        k: m[k]
        for k in (
            "vocab_size",
            "hidden_size",
            "num_layers",
            "num_heads",
            "intermediate_size",
            "max_position_embeddings",
            "hidden_dropout",
            "attention_dropout",
            "remat",
            "fused_attention",
            "fused_ffn",
        )
        if k in m
    }
    if "dtype" in m:
        overrides["dtype"] = _DTYPES[m.dtype]
    return dataclasses.replace(base, **overrides)


def check_vocab_compat(tokenizer, model_cfg) -> None:
    """Fail loudly when token ids can exceed the embedding table (an
    out-of-range id is a device assert on the GPU, garbage under XLA)."""
    inner = getattr(tokenizer, "tokenizer", tokenizer)
    # len() counts added tokens too; .vocab_size is the base vocab only
    candidates = [getattr(inner, "vocab_size", None)]
    try:
        candidates.append(len(inner))
    except TypeError:
        pass
    sizes = [int(v) for v in candidates if v]
    if not sizes:
        import warnings

        warnings.warn(
            "check_vocab_compat: cannot determine the tokenizer vocab size; "
            "out-of-range token ids would fail inside the embedding lookup."
        )
        return
    vs = max(sizes)
    if vs > model_cfg.vocab_size:
        raise ValueError(
            f"tokenizer vocab ({vs} ids incl. added tokens) exceeds model "
            f"vocab_size ({model_cfg.vocab_size}). Set "
            f"task.model.vocab_size={vs} or use a matching tokenizer."
        )


def load_weights(model: torch.nn.Module, cfg, seed: int = 0,
                 state_dict=None) -> torch.nn.Module:
    """``model`` with ``state_dict`` where one is given (e.g. dequantized
    weights), else with the params export ``task.checkpoint_path`` (a
    ``train.checkpoint.save_params`` directory or a bridged ``.npz``; a path
    that is missing, unreadable or of another model raises), or, when the
    key is unset, with weights drawn from ``seed`` with the JAX init's
    distributions (``models.convert.init_params``) and a warning."""
    path = cfg.task.get("checkpoint_path")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    elif path:
        model.load_state_dict(load_params(path))
        print(f"Loaded params from {path}")
    else:
        warnings.warn(
            "task.checkpoint_path is unset: encoding with RANDOM-INIT params "
            f"(seed {seed}). Retrieval quality will be garbage unless this is a "
            "test or a demo."
        )
        model.load_state_dict(init_params(model, torch.Generator().manual_seed(seed)))
    return model


def build_biencoder(cfg, device, seed: int = 0, state_dict=None):
    """The bi-encoder of ``task.model.family`` (``SpladeBiEncoder``'s
    vocab-sized vectors for ``splade``, the CLS ``BiEncoder`` otherwise) on
    ``device`` in eval mode, its weights from ``state_dict``,
    ``task.checkpoint_path`` or ``seed`` (:func:`load_weights`)."""
    t = cfg.task
    if t.model.get("family", "dense") == "splade":
        model = SpladeBiEncoder(build_model_config(cfg), shared=t.get("shared_model", True))
    else:
        model = BiEncoder(build_model_config(cfg), projection_dim=t.model.get("projection_dim", 0),
                          shared=t.get("shared_model", True))
    return load_weights(model, cfg, seed, state_dict).to(device).eval()


def build_lr_schedule(cfg, total_steps: int):
    o = cfg.task.optim
    return linear_warmup_decay(
        o.get("lr", 1e-5), cfg.task.get("warmup_steps", 0), total_steps
    )


def build_optimizer(cfg, total_steps: int):
    o = cfg.task.optim
    return make_optimizer(
        name=o.get("name", "adamw"),
        learning_rate=build_lr_schedule(cfg, total_steps),
        weight_decay=o.get("weight_decay", 0.0),
        betas=tuple(o.get("betas", (0.9, 0.999))),
        eps=o.get("eps"),
        grad_clip_norm=cfg.trainer.get("gradient_clip_val"),
        accumulate_steps=cfg.trainer.get("accumulate_grad_batches", 1),
    )


def build_task(cfg, optimizer, device):
    """The task of ``task.type``: dense (default), multivec or distill, with
    every key the JAX registry reads."""
    t = cfg.task
    task_type = t.get("type", "dense")
    if task_type == "distill":
        return DPRDistillTask(
            cfg=build_model_config(cfg),
            projection_dim=t.model.get("projection_dim", 0),
            k=t.get("k", 1),
            optimizer=optimizer,
            device=device,
        )
    if task_type == "multivec":
        return MultiVecRetrieverTask(
            cfg=build_model_config(cfg),
            variant=t.get("variant", "citadel"),
            tok_projection_dim=t.get("tok_projection_dim"),
            cls_projection_dim=t.get("cls_projection_dim"),
            add_cls=t.get("add_cls", False),
            query_topk=t.get("query_topk", 1),
            context_topk=t.get("context_topk", 1),
            shared_model=t.get("shared_model", True),
            query_pool=t.get("query_pool", "sum"),
            in_batch=t.get("in_batch", True),
            k=t.get("k", 1),
            query_expert_load_loss_coef=t.get("query_expert_load_loss_coef", 0.0),
            context_expert_load_loss_coef=t.get("context_expert_load_loss_coef", 0.0),
            query_router_marg_load_loss_coef=t.get("query_router_marg_load_loss_coef", 0.0),
            context_router_marg_load_loss_coef=t.get("context_router_marg_load_loss_coef", 0.0),
            anneal_factor=t.get("anneal_factor", 0.0),
            teacher_coef=t.get("teacher_coef", 0.0),
            tau=t.get("tau", 1.0),
            max_epochs=cfg.trainer.get("max_epochs", 1),
            optimizer=optimizer,
            device=device,
            grad_cache_chunks=t.get("grad_cache_chunks", 1),
        )
    return DenseRetrieverTask(
        cfg=build_model_config(cfg),
        projection_dim=t.model.get("projection_dim", 0),
        shared_model=t.get("shared_model", True),
        softmax_temperature=t.get("softmax_temperature", 1.0),
        k=t.get("k", 1),
        in_batch_negatives=t.get("in_batch_negatives", True),
        in_batch_eval=t.get("in_batch_eval", True),
        encoder_family=t.model.get("family", "dense"),
        optimizer=optimizer,
        device=device,
        grad_cache_chunks=t.get("grad_cache_chunks", 1),
    )


def build_datamodule(cfg, tokenizer: HFTokenizer):
    """The datamodule of ``task.type``: the distillation rows for distill,
    the DPR rows otherwise (``datamodule.num_workers`` worker processes
    build its batches)."""
    d = cfg.datamodule
    if cfg.task.get("type") == "distill":
        return DistillDataModule(
            tokenizer=tokenizer,
            train_path=d.get("train_path"),
            val_path=d.get("val_path"),
            test_path=d.get("test_path"),
            batch_size=d.get("batch_size", 8),
            pos_ctx_sample=d.get("pos_ctx_sample", True),
            drop_last=d.get("drop_last", True),
            seed=d.get("seed", 0),
        )
    return DenseRetrieverDataModule(
        tokenizer=tokenizer,
        train_path=d.get("train_path"),
        val_path=d.get("val_path"),
        test_path=d.get("test_path"),
        corpus_path=d.get("corpus_path"),
        batch_size=d.get("batch_size", 2),
        val_batch_size=d.get("val_batch_size", 0),
        test_batch_size=d.get("test_batch_size", 0),
        num_positive=d.get("num_positive", 1),
        num_negative=d.get("num_negative", 7),
        neg_ctx_sample=d.get("neg_ctx_sample", True),
        pos_ctx_sample=d.get("pos_ctx_sample", False),
        num_val_negative=d.get("num_val_negative", 7),
        num_test_negative=d.get("num_test_negative"),
        use_title=d.get("use_title", False),
        sep_token=d.get("sep_token"),
        rel_sample=d.get("rel_sample", False),
        drop_last=d.get("drop_last", True),
        seed=d.get("seed", 0),
        prefetch_batches=d.get("prefetch_batches", 2),
        num_workers=d.get("num_workers", 0),
        contiguous_chunks=d.get("contiguous_chunks", 0),
        query_max_seq_len=d.get("query_max_seq_len"),
        ctx_max_seq_len=d.get("ctx_max_seq_len"),
    )
