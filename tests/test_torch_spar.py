"""SPAR and DrBoost in the port (``models.ensemble``, ``retrieve.spar``,
``tools.spar_retrieval``, ``tools.tune_spar_weights``) against the JAX
package's, on the CPU.

Embedding directories and query vectors come from a numpy seed; the
encoders' weights cross from Flax through ``from_jax_params``. Tolerances:
combined vectors byte for byte (the same numpy arithmetic); the ensemble's
embeddings within 1e-5 abs; the top-k ids equal and their scores within
1e-5 relative (bf16 index products summed in another order); the tuning's
recalls and best weight equal.
"""
import dataclasses
import importlib.util
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpr_scale_tpu.models import BiEncoder as JaxBiEncoder
from dpr_scale_tpu.models import TransformerConfig as JaxConfig
from dpr_scale_tpu.models.ensemble import ConcatEncoders as JaxConcat
from dpr_scale_tpu.parallel import get_mesh
from dpr_scale_tpu.retrieve import spar as jax_spar
from dpr_scale_tpu_torch.encode.embeddings import save_embedding_shard
from dpr_scale_tpu_torch.models.convert import from_jax_params
from dpr_scale_tpu_torch.models.encoder import BiEncoder
from dpr_scale_tpu_torch.models.ensemble import ConcatEncoders
from dpr_scale_tpu_torch.models.transformer import TransformerConfig
from dpr_scale_tpu_torch.retrieve import spar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, Q, D1, D2, K = 40, 6, 16, 12, 5
WORDS = list("abcdefghij") + ["who", "what", "book", "city"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spar")
    rng = np.random.default_rng(2)
    with open(d / "passages.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        for i in range(N):
            f.write(f"{i}\t{' '.join(rng.choice(WORDS, size=5))}\tt{i}\n")
    with open(d / "questions.csv", "w") as f:
        for i in range(Q):
            f.write(f"what {WORDS[i]} book\t{[WORDS[i]]}\n")
    for name, dim in (("base", D1), ("lambda", D2)):
        (d / name).mkdir()
        p = rng.normal(size=(N, dim)).astype(np.float32)
        save_embedding_shard(str(d / name / "reps_0000"), p[:25], "pickle")
        save_embedding_shard(str(d / name / "reps_0001"), p[25:], "pickle")
        with open(d / name / "query_reps.pkl", "wb") as f:
            pickle.dump(rng.normal(size=(Q, dim)).astype(np.float32), f, protocol=4)
    return d


@pytest.mark.parametrize("pooling", ["concat", "mean", "sum"])
def test_combined_vectors_equal_jax(dirs, pooling):
    a = spar.load_dir_embeddings(str(dirs / "base"))
    assert np.array_equal(a, jax_spar.load_dir_embeddings(str(dirs / "base")))
    b = spar.load_dir_embeddings(str(dirs / "lambda"))
    qa, qb = (spar.load_query_embeddings(str(dirs / n)) for n in ("base", "lambda"))
    if pooling != "concat":  # mean and sum take equal widths
        a, qa = a[:, :D2], qa[:, :D2]
    got = spar.combine_passage_vectors(a, b, pooling), spar.combine_query_vectors(qa, qb, 0.7, pooling)
    want = (jax_spar.combine_passage_vectors(a, b, pooling),
            jax_spar.combine_query_vectors(qa, qb, 0.7, pooling))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_concat_encoders_equal_jax():
    """DrBoost / SPAR composition: two bi-encoders, the query weight on the
    second's query vectors only."""
    jcfg = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32, hidden_size=64,
                               num_heads=4, intermediate_size=128)
    tcfg = TransformerConfig(vocab_size=32, hidden_size=64, num_layers=2, num_heads=4,
                             intermediate_size=128, max_position_embeddings=64,
                             hidden_dropout=0.0, attention_dropout=0.0, dtype=torch.float32)
    ids = np.random.default_rng(0).integers(5, 32, size=(3, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    jcomp, tcomp = [], []
    for seed in (0, 1):
        jm = JaxBiEncoder(jcfg)
        params = jm.init(jax.random.PRNGKey(seed), *(jnp.asarray(ids),) * 4)["params"]
        jcomp.append((jm, params))
        tm = BiEncoder(tcfg)
        tm.load_state_dict(from_jax_params(jax.device_get(params)))
        tcomp.append(tm.eval())
    jens, tens = JaxConcat(jcomp, [1.0, 0.7]), ConcatEncoders(tcomp, [1.0, 0.7])
    tq = tens.encode_queries(torch.from_numpy(ids), torch.from_numpy(mask))
    tc = tens.encode_contexts(torch.from_numpy(ids), torch.from_numpy(mask))
    assert tq.shape == tc.shape == (3, 128)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jens.encode_queries(ids, mask)), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jens.encode_contexts(ids, mask)), atol=1e-5)
    np.testing.assert_allclose(tq[:, 64:].numpy(), 0.7 * tc[:, 64:].numpy(), atol=1e-5)


def test_spar_retrieval_tool_equals_jax(dirs, tmp_path):
    from dpr_scale_tpu.data.datasets import QueryCSVDataset
    from dpr_scale_tpu_torch.tools import spar_retrieval

    common = dict(passages_path=str(dirs / "passages.tsv"), ctx_embeddings_dir_1=str(dirs / "base"),
                  ctx_embeddings_dir_2=str(dirs / "lambda"))
    ds = QueryCSVDataset(str(dirs / "questions.csv"))
    jax_spar.run_spar_retrieval([[ds[i] for i in range(len(ds))]], output_dir=str(tmp_path / "jax"),
                                output_filenames=["out.json"], mesh=get_mesh(1), weights=[0.7],
                                save_embeddings=True, topk=K, **common)
    spar_retrieval.main([
        "--jsonl_dataset_paths", str(dirs / "questions.csv"),
        "--tsv_passages_path", common["passages_path"],
        "--ctx_embeddings_dir_1", common["ctx_embeddings_dir_1"],
        "--ctx_embeddings_dir_2", common["ctx_embeddings_dir_2"],
        "--output_dir", str(tmp_path / "port"), "--output_filenames", "out.json",
        "--weights", "0.7", "--save_embeddings", "--topk", str(K), "--device", "cpu"])
    runs = {s: json.load(open(tmp_path / s / "out.json")) for s in ("jax", "port")}
    for g, w in zip(runs["port"], runs["jax"]):
        assert [c["id"] for c in g["ctxs"]] == [c["id"] for c in w["ctxs"]]
        np.testing.assert_allclose([c["score"] for c in g["ctxs"]], [c["score"] for c in w["ctxs"]],
                                   rtol=1e-5, atol=1e-6)
    for i in range(8):  # the re-saved combined shards and queries
        name = f"reps_{i:04}.pkl"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert (tmp_path / "port/query_reps.pkl").read_bytes() == \
        (tmp_path / "jax/query_reps.pkl").read_bytes()


def test_tune_spar_weights_tool_equals_jax(dirs, tmp_path, monkeypatch):
    from dpr_scale_tpu_torch.tools import tune_spar_weights

    # the tool needs equal widths only for mean / sum; concat scoring takes any
    args = ["--queries", str(dirs / "questions.csv"),
            "--tsv_passages_path", str(dirs / "passages.tsv"),
            "--ctx_embeddings_dir_1", str(dirs / "base"),
            "--ctx_embeddings_dir_2", str(dirs / "lambda"),
            "--weights", "0.3", "0.7", "1.0", "--topk", "10", "--eval_on_ks", "2", "10"]
    tune_spar_weights.main(args + ["--output_json", str(tmp_path / "port.json")])
    spec = importlib.util.spec_from_file_location("jax_tune", os.path.join(ROOT, "tools",
                                                                           "tune_spar_weights.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["tune_spar_weights.py", *args, "--output_json",
                                      str(tmp_path / "jax.json")])
    tool.main()
    got, want = json.load(open(tmp_path / "port.json")), json.load(open(tmp_path / "jax.json"))
    assert got == want and got["questions.csv"]["best_weight"] in (0.3, 0.7, 1.0)
