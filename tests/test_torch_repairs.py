"""Faults of the port where it answered otherwise than the JAX package:

* ``remat: true`` (conf/task/model/bert_large.yaml) made the encoder refuse
  to run at all, inference included; JAX only wraps each layer in
  ``nn.remat``, which changes no forward value. Now a forward without
  gradients runs as without the flag, and training recomputes each layer;
* ``generate_embeddings`` ignored ``task.exported_encoder_path`` and
  ``task.quantized_checkpoint_path`` and wrote shards from seeded weights;
  it raised for a while, and since the exporter is ported it reads both
  (the exported program, the dequantized int8 weights);
* ``cli.serve`` ignored ``serve_citadel`` and served the dense tower alone;
  it now builds the CITADEL tower (``/search_citadel``) and refuses only
  ``serve_citadel.expert_parallel`` (ROADMAP A12);
* ``cli.train`` dropped ``trainer.tensorboard_dir`` (now handed to the
  logger, as JAX does), ``trainer.profile_dir`` (now handed to the
  trainer's profiler) and ``trainer.num_devices`` (now more than one device is
  refused, and so is an absent or null key while more than one CUDA device
  is visible: multi-GPU training is ROADMAP A5);
* refusals named the wrong ROADMAP item; the one that remains names A5
  (more than one device); the distillation task and worker processes,
  once refused naming A8, now run.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from dpr_scale_tpu_torch.cli import generate_embeddings, serve, train
from dpr_scale_tpu_torch.config import load_config

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
# bert_large's preset and model file, cut to a tiny width (fp32 for exact equality)
TINY_LARGE = ["task.model.arch=bert_large", "task.model.hidden_size=16",
              "task.model.num_layers=3", "task.model.num_heads=2",
              "task.model.intermediate_size=32", "task.model.vocab_size=32",
              "task.model.dtype=float32"]


@pytest.fixture
def passages(tmp_path):
    words = list("abcdefghij")
    rng = np.random.default_rng(0)
    path = tmp_path / "passages.tsv"
    with open(path, "w") as f:
        f.write("id\ttext\ttitle\n")
        for i in range(13):
            f.write(f"p{i}\t{' '.join(rng.choice(words, size=6))}\tt{i}\n")
    return path


def _argv(tiny_bert_dir, passages, out, *extra):
    return ["--config", os.path.join(CONF, "tiny_smoke.yaml"), "--device", "cpu",
            f"task.transform.model_path={tiny_bert_dir}", f"datamodule.passages_path={passages}",
            f"task.ctx_embeddings_dir={out}", "datamodule.encode_batch_size=4", *TINY_LARGE,
            *extra]


def test_remat_encodes_as_without_it_and_refuses_training(tiny_bert_dir, passages, tmp_path):
    shards = {}
    for remat in ("true", "false"):
        path = generate_embeddings.main(_argv(tiny_bert_dir, passages, tmp_path / remat,
                                              f"task.model.remat={remat}"))
        with open(path, "rb") as f:
            shards[remat] = pickle.load(f)
    assert shards["true"].shape == (13, 16)
    np.testing.assert_array_equal(shards["true"], shards["false"])

    from dpr_scale_tpu_torch.cli.common import build_biencoder, build_task
    from dpr_scale_tpu_torch.optim.factory import AdamW

    cfg = load_config(os.path.join(CONF, "tiny_smoke.yaml"),
                      TINY_LARGE + ["task.model.remat=true"])
    task = build_task(cfg, AdamW(1e-3), "cpu")  # trains: remat is no longer refused
    assert task.cfg.remat
    model = build_biencoder(cfg, "cpu")
    ids = torch.ones((2, 5), dtype=torch.int64)
    with torch.no_grad():
        want = model.encode_query(ids, torch.ones_like(ids))
    assert want.shape == (2, 16)
    got = model.encode_query(ids, torch.ones_like(ids))  # a gradient would be taken
    assert got.requires_grad and torch.equal(got.detach(), want)
    got.sum().backward()
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("key", ["exported_encoder_path", "quantized_checkpoint_path"])
def test_generate_embeddings_refuses_the_encoders_it_cannot_read(tiny_bert_dir, passages,
                                                                  tmp_path, key):
    """Both keys are read now (they raised naming A8 before the exporter was
    ported): the seeded model exported as a program writes the shard the
    model writes (1e-6), its int8 weights one within cosine 0.999 of it."""
    from dpr_scale_tpu_torch.cli.common import build_biencoder
    from dpr_scale_tpu_torch.utils import export

    cfg = load_config(os.path.join(CONF, "tiny_smoke.yaml"), TINY_LARGE)
    model = build_biencoder(cfg, "cpu")
    if key == "exported_encoder_path":
        path = export.export_encoder(export.EncoderTower(model), 4, 16, str(tmp_path / "enc"))
    else:
        path = export.save_quantized(str(tmp_path / "q.pt"), model)
    with open(generate_embeddings.main(_argv(tiny_bert_dir, passages, tmp_path / "seeded")),
              "rb") as f:
        want = pickle.load(f)
    with open(generate_embeddings.main(_argv(tiny_bert_dir, passages, tmp_path / "out",
                                             f"task.{key}={path}")), "rb") as f:
        got = pickle.load(f)
    assert got.shape == want.shape == (13, 16)
    if key == "exported_encoder_path":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
        assert cos.min() >= 0.999 and not np.array_equal(got, want)


def test_serve_refuses_the_citadel_tower(tiny_bert_dir, passages, tmp_path):
    """``serve_citadel`` is no longer ignored: it builds the CITADEL tower,
    which answers; of its keys only ``expert_parallel`` (several devices,
    ROADMAP A12) is refused."""
    from dpr_scale_tpu_torch.cli import generate_multivec_embeddings

    multivec = [f"task.transform.model_path={tiny_bert_dir}", "task.model.vocab_size=32",
                "task.transform.max_seq_len=12", "task.type=multivec",
                "task.tok_projection_dim=8", "task.context_topk=2",
                f"datamodule.passages_path={passages}", "datamodule.encode_batch_size=4"]
    generate_multivec_embeddings.main(["--config", os.path.join(CONF, "tiny_smoke.yaml"),
                                       "--device", "cpu", *multivec,
                                       f"task.ctx_embeddings_dir={tmp_path}/citadel"])
    tower = [*multivec, f"serve_citadel.ctx_embeddings_dir={tmp_path}/citadel", "serve_citadel.k=3"]
    with pytest.raises(NotImplementedError, match="serve_citadel.expert_parallel.*A12"):
        serve.build_citadel_retriever(load_config(os.path.join(CONF, "tiny_smoke.yaml"), [
            *tower, "serve_citadel.expert_parallel=true"]), device="cpu")
    retriever = serve.build_citadel_retriever(
        load_config(os.path.join(CONF, "tiny_smoke.yaml"), tower), device="cpu")
    (results,) = retriever.search(["what a book"])
    assert len(results) == 3 and {"id", "title", "text", "score"} == set(results[0])


def _train_argv(tiny_bert_dir, dpr10_jsonl, *extra):
    return ["--config", os.path.join(CONF, "tiny_smoke.yaml"), "--device", "cpu",
            f"task.transform.model_path={tiny_bert_dir}", f"datamodule.train_path={dpr10_jsonl}",
            f"datamodule.val_path={dpr10_jsonl}", f"datamodule.test_path={dpr10_jsonl}", *extra]


def test_cli_train_hands_tensorboard_dir_to_the_logger(tiny_bert_dir, dpr10_jsonl, tmp_path,
                                                       monkeypatch):
    """C5: both of the JAX CLI's logger keys reach ``MetricLogger``."""
    seen = {}

    class Stop(Exception):
        pass

    def logger(**kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(train, "MetricLogger", logger)
    tb, jsonl = str(tmp_path / "tb"), str(tmp_path / "m.jsonl")
    with pytest.raises(Stop):
        train.main(_train_argv(tiny_bert_dir, dpr10_jsonl, f"trainer.tensorboard_dir={tb}",
                               f"trainer.metrics_jsonl={jsonl}"))
    assert seen == {"jsonl_path": jsonl, "tensorboard_dir": tb}


@pytest.mark.parametrize("extra,item", [
    (["trainer.num_devices=2"], "num_devices=2.*A5"),
    (["task.type=distill"], None),
], ids=["num_devices", "distill"])
def test_cli_train_refusals_name_their_roadmap_item(tiny_bert_dir, dpr10_jsonl, tmp_path, extra,
                                                    item):
    """C6-C8: each refusal of ``cli.train`` names the item that ports it,
    and none names the exporter of A1. ``task.type=distill`` (refused naming
    A8 until the distillation task was ported) now trains on rows with
    teacher vectors."""
    if item is None:
        import json

        rng = np.random.default_rng(0)
        rows = tmp_path / "distill.jsonl"
        rows.write_text("".join(json.dumps({
            "question": f"who wrote book {i}",
            "ctx_target_vectors": [rng.normal(size=16).tolist()],
            "qry_target_vector": rng.normal(size=16).tolist()}) + "\n" for i in range(8)))
        metrics = train.main(_train_argv(tiny_bert_dir, str(rows), *extra))
        assert metrics["query_count"] == 16 and np.isfinite(metrics["loss"])
        return
    with pytest.raises(NotImplementedError, match=item) as err:
        train.main(_train_argv(tiny_bert_dir, dpr10_jsonl, *extra))
    msg = str(err.value)
    assert "A1" not in msg and ("A5" not in msg or "A5" in item), msg


@pytest.mark.parametrize("num_devices,device,visible,refused", [
    (None, "cuda:0", 2, True),
    (None, "cuda:0", 1, False),
    (None, "cpu", 4, False),
    (1, "cuda:0", 4, False),
    (2, "cpu", 0, True),
])
def test_cli_train_refuses_more_than_one_device(monkeypatch, num_devices, device, visible,
                                                refused):
    """C7: the JAX trainer runs data-parallel over ``trainer.num_devices``
    devices, all visible ones when the key is null or absent; the port runs
    on one, so it refuses both unless one device is all there is."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    overrides = [] if num_devices is None else [f"trainer.num_devices={num_devices}"]
    cfg = load_config(os.path.join(CONF, "tiny_smoke.yaml"), overrides)
    assert cfg.trainer.get("num_devices") == num_devices
    if refused:
        with pytest.raises(NotImplementedError, match="num_devices.*A5"):
            train._refuse_unported(cfg, torch.device(device))
    else:
        train._refuse_unported(cfg, torch.device(device))
