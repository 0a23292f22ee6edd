"""``cli.train`` with ``task.type=multivec`` (conf/tiny_smoke.yaml cut to a
tiny CITADEL) against the JAX CLI from the same Flax weights, then each
side's exported ``params_best`` through ``generate_multivec_embeddings`` and
``citadel_retrieval``, on the CPU.

Both runs start from one Flax init (``task.pretrained_checkpoint_path``: the
JAX export for the JAX CLI, its state dict through ``from_jax_params`` for
the port) and train 2 epochs of the same batches with teacher
distillation and every regulariser (annealed by epoch). The test metrics
of the best step within 1e-4 relative, the retrieval scores of the two
exports within 1e-4 (the CITADEL CLI tests' tolerance).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpr_scale_tpu_torch.cli import citadel_retrieval, generate_multivec_embeddings, train
from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.train.checkpoint import save_params

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
MULTIVEC = ["task.model.vocab_size=32", "task.transform.max_seq_len=12", "task.type=multivec",
            "task.variant=citadel", "task.tok_projection_dim=8", "task.cls_projection_dim=8",
            "task.add_cls=true", "task.query_topk=1", "task.context_topk=2",
            "task.teacher_coef=0.3", "task.query_expert_load_loss_coef=0.01",
            "task.context_expert_load_loss_coef=0.01",
            "task.query_router_marg_load_loss_coef=0.01",
            "task.context_router_marg_load_loss_coef=0.01", "task.anneal_factor=1.0"]


def _trec(path):
    out = {}
    for line in open(path):
        qid, _q0, doc, _rank, score, _tag = line.split()
        out.setdefault(qid, []).append((doc, float(score)))
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory, tiny_bert_dir, dpr10_jsonl):
    """Both CLIs trained from one Flax init; each side's test metrics."""
    from dpr_scale_tpu.cli import train as jax_train
    from dpr_scale_tpu.cli.common import build_task as jax_build_task
    from dpr_scale_tpu.config import load_config as jax_load_config
    from dpr_scale_tpu.train.checkpoint import save_params as jax_save_params

    d = tmp_path_factory.mktemp("multivec_cli")
    common = ["--config", os.path.join(CONF, "tiny_smoke.yaml"),
              f"task.transform.model_path={tiny_bert_dir}", *MULTIVEC,
              f"datamodule.train_path={dpr10_jsonl}", f"datamodule.val_path={dpr10_jsonl}",
              f"datamodule.test_path={dpr10_jsonl}", "trainer.num_devices=1"]
    task = jax_build_task(jax_load_config(common[1], common[2:]))
    ones = jnp.ones((1, 12), jnp.int32)
    params = task.model.init(jax.random.PRNGKey(5), ones, ones, topk=2, add_cls=True)["params"]
    params = jax.device_get(params)
    jax_save_params(str(d / "init_jax"), params)
    save_params(str(d / "init_port"), from_jax_params(params))
    metrics = {}
    for side, main, argv in (("jax", jax_train.main, common),
                             ("port", train.main, common[:2] + ["--device", "cpu"] + common[2:])):
        metrics[side] = main(argv + [f"task.pretrained_checkpoint_path={d}/init_{side}",
                                     f"checkpoint_callback.dirpath={d}/ckpt_{side}",
                                     f"trainer.metrics_jsonl={d}/{side}.jsonl"])
    return d, metrics


def test_cli_train_multivec_matches_the_jax_cli(trained):
    d, metrics = trained
    want, got = metrics["jax"], metrics["port"]
    assert set(got) == set(want) and got["query_count"] == want["query_count"] > 0
    for key in want:
        np.testing.assert_allclose(got[key], float(want[key]), rtol=1e-4, err_msg=key)
    logged = [json.loads(l) for l in open(d / "port.jsonl")]
    assert any("valid_mrr" in l for l in logged)
    assert os.path.exists(d / "ckpt_port" / "params_best")


def test_export_encodes_and_retrieves_as_the_jax_export(trained, tiny_bert_dir, tmp_path):
    """Each side's export through its own CLIs: the same expert shards'
    documents and the same ranked scores."""
    from dpr_scale_tpu.cli import citadel_retrieval as jax_citadel
    from dpr_scale_tpu.cli import generate_multivec_embeddings as jax_multivec

    d, _ = trained
    words = list("abcdefghij")
    with open(tmp_path / "passages.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        f.writelines(f"p{i}\t{words[i % 10]} {words[(3 * i) % 10]} book\tcity {i % 3}\n"
                     for i in range(12))
    with open(tmp_path / "queries.tsv", "w") as f:
        f.writelines(f"q{i}\twhat {words[i]} book\n" for i in range(5))
    base = ["--config", os.path.join(CONF, "tiny_smoke.yaml"),
            f"task.transform.model_path={tiny_bert_dir}", *MULTIVEC,
            f"datamodule.passages_path={tmp_path}/passages.tsv",
            f"datamodule.test_path={tmp_path}/queries.tsv", "datamodule.trec_format=true",
            "datamodule.encode_batch_size=4"]
    for side, gen, cit, argv in (
            ("jax", jax_multivec.main, jax_citadel.main, base),
            ("port", generate_multivec_embeddings.main, citadel_retrieval.main,
             base[:2] + ["--device", "cpu"] + base[2:])):
        argv = argv + [f"task.checkpoint_path={d}/ckpt_{side}/params_best",
                       f"task.ctx_embeddings_dir={tmp_path}/{side}_index"]
        gen(argv)
        cit(argv + ["task.topk=6", f"task.output_trec_path={tmp_path}/{side}.trec"])
    assert sorted(os.listdir(tmp_path / "port_index" / "expert_0000")) == \
        sorted(os.listdir(tmp_path / "jax_index" / "expert_0000"))
    want, got = _trec(tmp_path / "jax.trec"), _trec(tmp_path / "port.trec")
    assert got.keys() == want.keys() and len(want) == 5
    for qid in want:
        np.testing.assert_allclose([s for _d, s in got[qid]], [s for _d, s in want[qid]],
                                   rtol=0, atol=1e-4)
