"""Faults of the port where it answered otherwise than the JAX package:

* ``remat: true`` (conf/task/model/bert_large.yaml) made the encoder refuse
  to run at all, inference included; JAX only wraps each layer in
  ``nn.remat``, which changes no forward value. Now a forward without
  gradients runs as without the flag, and training raises;
* ``generate_embeddings`` ignored ``task.exported_encoder_path`` and
  ``task.quantized_checkpoint_path`` and wrote shards from seeded weights;
  it now raises (their readers are ROADMAP A8);
* ``cli.serve`` ignored ``serve_citadel`` and served the dense tower alone;
  it now raises (the CITADEL tower is ROADMAP A7).
"""
import os
import pickle

import numpy as np
import pytest
import torch

from dpr_scale_tpu_torch.cli import generate_embeddings, serve
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
    with pytest.raises(NotImplementedError, match="dropout generators"):
        build_task(cfg, AdamW(1e-3), "cpu")
    model = build_biencoder(cfg, "cpu")
    ids = torch.ones((2, 5), dtype=torch.int64)
    with torch.no_grad():
        assert model.encode_query(ids, torch.ones_like(ids)).shape == (2, 16)
    with pytest.raises(NotImplementedError, match="dropout generators"):
        model.encode_query(ids, torch.ones_like(ids))  # a gradient would be taken


@pytest.mark.parametrize("key", ["exported_encoder_path", "quantized_checkpoint_path"])
def test_generate_embeddings_refuses_the_encoders_it_cannot_read(tiny_bert_dir, passages,
                                                                  tmp_path, key):
    with pytest.raises(NotImplementedError, match=f"{key}.*A8"):
        generate_embeddings.main(_argv(tiny_bert_dir, passages, tmp_path / "out",
                                       f"task.{key}=/models/enc"))
    assert not (tmp_path / "out").exists()


def test_serve_refuses_the_citadel_tower(tiny_bert_dir, tmp_path):
    cfg = load_config(os.path.join(CONF, "tiny_smoke.yaml"), [
        f"task.transform.model_path={tiny_bert_dir}", "task.model.vocab_size=32",
        f"task.ctx_embeddings_dir={tmp_path}",
        f"serve_citadel.ctx_embeddings_dir={tmp_path}/citadel"])
    with pytest.raises(NotImplementedError, match="serve_citadel.*A7"):
        serve.build_retriever(cfg, device="cpu")
