"""The quantised tiers through the port's retrieval entry points on the CPU,
held against the JAX package: ``ShardRowReader``, ``run_retrieval`` with
``task.mips_method=int8|int4``, ``task.rerank_oversample`` and
``task.int8_query_planes``, and ``run_retrieval_multiset``.

Given the same shards and the same query embeddings both CLIs return the
exact top-k of the same dequantised scores (see tests/test_torch_int_mips.py
for the tie rule and the two-plane tolerance); a rerank returns the same fp32
rescores. The JAX shard listing takes a ``.rerank.npy`` sidecar for a shard
(the port's does not), so every run that reranks gets its own copy of the
shards.
"""
import json
import os
import pickle
import shutil

import numpy as np
import pytest

from dpr_scale_tpu.encode.embeddings import ShardRowReader as JaxShardRowReader
from dpr_scale_tpu_torch.cli import run_retrieval, run_retrieval_multiset
from dpr_scale_tpu_torch.encode.embeddings import (
    ShardRowReader,
    load_embedding_shards,
    save_embedding_shard,
)
from dpr_scale_tpu_torch.retrieve.retrieval import build_index, retrieve

from test_torch_int_mips import assert_same_topk

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
WORDS = list("abcdefghij") + ["who", "what", "book", "city", "text", "title"]
N_PASSAGES, N_QUERIES, DIM, TOPK = 300, 10, 32, 7


@pytest.fixture(scope="module")
def setup(tmp_path_factory, tiny_bert_dir):
    d = tmp_path_factory.mktemp("torch_int_cli")
    rng = np.random.default_rng(0)
    with open(d / "passages.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        for i in range(N_PASSAGES):
            f.write(f"p{i}\t{' '.join(rng.choice(WORDS, size=5))}\ttitle {WORDS[i % 10]}\n")
    with open(d / "questions.csv", "w") as f:  # question \t python list of answers
        for i in range(N_QUERIES):
            f.write(f"what {WORDS[i]} book\t{[WORDS[i], 'city']}\n")
    embs = d / "embs"
    embs.mkdir()
    corpus = rng.normal(size=(N_PASSAGES, DIM)).astype(np.float32)
    save_embedding_shard(str(embs / "reps_0000"), corpus[:170], "pickle")
    save_embedding_shard(str(embs / "reps_0001"), corpus[170:].astype(np.float16), "npy")
    qpath = d / "query_vectors.pkl"
    with open(qpath, "wb") as f:
        pickle.dump(rng.normal(size=(N_QUERIES, DIM)).astype(np.float32), f, protocol=4)
    common = [
        "--config", os.path.join(CONF, "tiny_smoke.yaml"),
        f"task.transform.model_path={tiny_bert_dir}", "task.model.vocab_size=32",
        f"datamodule.passages_path={d}/passages.tsv", f"datamodule.test_path={d}/questions.csv",
        f"task.topk={TOPK}", "task.query_batch=4",  # 10 queries: the last batch is padded
    ]
    return d, common, str(qpath)


def _embs_for(d, tag, rerank):
    """The shared shards, or a copy of them for a run that builds sidecars."""
    if not rerank:
        return d / "embs"
    dst = d / f"embs_{tag}"
    if not dst.exists():
        shutil.copytree(d / "embs", dst)
    return dst


def _as_arrays(payload):
    ids = np.array([[int(c["id"][1:]) for c in row["ctxs"]] for row in payload], np.int64)
    scores = np.array([[c["score"] for c in row["ctxs"]] for row in payload], np.float32)
    return scores, ids


def _run_both(d, common, qpath, options):
    rerank = any("rerank" in o for o in options)
    tag = "_".join(o.split("=")[-1] for o in options)
    outs = {}
    for side in ("jax", "port"):
        embs = _embs_for(d, f"{side}_{tag}", rerank)
        out = [f"task.ctx_embeddings_dir={embs}", f"task.query_emb_path={qpath}", *options,
               f"task.output_path={d}/{side}_{tag}.json",
               f"task.output_trec_path={d}/{side}_{tag}.trec"]
        if side == "jax":
            from dpr_scale_tpu.cli import run_retrieval as jax_run_retrieval

            jax_run_retrieval.main(common + out)
        else:
            run_retrieval.main(common[:2] + ["--device", "cpu"] + common[2:] + out)
        with open(f"{d}/{side}_{tag}.json") as f:
            payload = json.load(f)
        with open(f"{d}/{side}_{tag}.trec") as f:
            trec = [line.split() for line in f]
        outs[side] = payload, trec
    return outs["jax"], outs["port"]


@pytest.mark.parametrize("options,rtol", [
    (["task.mips_method=int8"], 0.0),
    (["task.mips_method=int4"], 0.0),
    (["task.mips_method=int8", "task.int8_query_planes=2"], 1e-6),
    (["task.mips_method=int4", "task.int8_query_planes=2"], 1e-6),
    (["task.mips_method=int4", "task.rerank_oversample=4"], 0.0),
    (["task.mips_method=int8", "task.rerank_oversample=2", "task.int8_query_planes=2"], 0.0),
], ids=["int8", "int4", "int8-planes2", "int4-planes2", "int4-rerank4", "int8-rerank2-planes2"])
def test_run_retrieval_matches_the_jax_cli(setup, options, rtol):
    d, common, qpath = setup
    (want, want_trec), (got, got_trec) = _run_both(d, common, qpath, options)
    assert len(got) == len(want) == N_QUERIES
    for g, w in zip(got, want):
        assert (g["question"], g["answers"]) == (w["question"], w["answers"])
        assert len(g["ctxs"]) == TOPK
    assert_same_topk(*_as_arrays(got), *_as_arrays(want), rtol)
    if "rerank" in " ".join(options):  # exact fp32 rescores of the shards' rows
        with open(qpath, "rb") as f:
            q = pickle.load(f)
        s, i = _as_arrays(got)
        rows = np.concatenate([e for _n, e in load_embedding_shards(str(d / "embs"))])
        np.testing.assert_allclose(s, np.einsum("bd,bkd->bk", q, rows[i]), rtol=1e-6)
    np.testing.assert_allclose([float(r[4]) for r in got_trec], [float(r[4]) for r in want_trec],
                               rtol=max(rtol, 1e-6), atol=2e-6)


def test_rerank_needs_a_lossy_index(setup, tmp_path):
    """As the JAX retrieve(): the index searched decides, a given exact one
    raises; a given int4 one with the default method argument reranks."""
    d, _common, qpath = setup
    embs = shutil.copytree(d / "embs", tmp_path / "embs")
    with open(qpath, "rb") as f:
        q = pickle.load(f)
    questions = [{"question": f"q{i}", "answers": []} for i in range(N_QUERIES)]
    with pytest.raises(ValueError, match="lossy"):
        retrieve(q, questions, f"{d}/passages.tsv", str(embs), "cpu", k=5,
                 index=build_index(str(embs), "cpu", method="groupmax"), rerank_oversample=4)
    index = build_index(str(embs), "cpu", method="int4")
    res = retrieve(q, questions, f"{d}/passages.tsv", str(embs), "cpu", k=5, index=index,
                   rerank_oversample=60, int8_query_planes=2)
    assert index.int8_query_planes == 2 and index.rerank_oversample == 60
    corpus = ShardRowReader(str(embs))(np.arange(N_PASSAGES))
    exact = q @ corpus.T
    for b, ctxs in enumerate(res):  # a pool of 300 rows: the exact top-5
        assert [c["id"] for c in ctxs] == [f"p{j}" for j in np.argsort(-exact[b])[:5]]


def test_shard_row_reader_matches_jax_on_mixed_shards(tmp_path):
    """A .pkl shard (an fp32 sidecar is built once and reused while the
    pickle is unchanged) and an fp16 .npy shard (memory-mapped, upcast):
    the port's reader returns the JAX reader's rows bit for bit, and the
    sidecar is no shard of its own."""
    rng = np.random.default_rng(49)
    a = rng.normal(size=(100, 8)).astype(np.float32)
    b = rng.normal(size=(60, 8)).astype(np.float16)
    save_embedding_shard(str(tmp_path / "reps_0000"), a, "pickle")
    save_embedding_shard(str(tmp_path / "reps_0001"), b, "npy")
    ids = np.array([0, 99, 100, 159, 5, 120, 5], np.int64)
    r = ShardRowReader(str(tmp_path))
    assert (r.num_rows, r.dim) == (160, 8)
    got = r(ids)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.concatenate([a, b.astype(np.float32)])[ids])
    sidecar = tmp_path / "reps_0000.pkl.rerank.npy"
    mtime = sidecar.stat().st_mtime_ns
    jax_reader = JaxShardRowReader(str(tmp_path))  # reuses the port's sidecar
    np.testing.assert_array_equal(jax_reader(ids), got)
    again = ShardRowReader(str(tmp_path))
    assert sidecar.stat().st_mtime_ns == mtime and again.num_rows == 160
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ShardRowReader(str(tmp_path / "empty"))


@pytest.mark.parametrize("method", ["int4", "fused"])
def test_run_retrieval_multiset_matches_the_jax_cli(setup, method):
    """One index, two query sets (the second a TREC file), both CLIs."""
    d, common, qpath = setup
    with open(d / "queries.trec.tsv", "w") as f:
        for i in range(6):
            f.write(f"q{i}\t{WORDS[i]} city text\n")
    rng = np.random.default_rng(5)
    q2 = d / "q2.pkl"
    with open(q2, "wb") as f:
        pickle.dump(rng.normal(size=(6, DIM)).astype(np.float32), f, protocol=4)
    outs = {}
    for side in ("jax", "port"):
        sets = (f"[{{query_emb_path: {qpath}, test_path: {d}/questions.csv, "
                f"output_path: {d}/ms_{side}_{method}_1.json}}, "
                f"{{query_emb_path: {q2}, test_path: {d}/queries.trec.tsv, trec_format: true, "
                f"output_path: {d}/ms_{side}_{method}_2.json, "
                f"output_trec_path: {d}/ms_{side}_{method}_2.trec}}]")
        argv = common + [f"task.ctx_embeddings_dir={d}/embs", f"task.mips_method={method}",
                         f"task.query_sets={sets}"]
        if side == "jax":
            from dpr_scale_tpu.cli import run_retrieval_multiset as jax_multiset

            outs[side] = jax_multiset.main(argv)
        else:
            outs[side] = run_retrieval_multiset.main(argv[:2] + ["--device", "cpu"] + argv[2:])
    assert outs["port"] == [f"{d}/ms_port_{method}_1.json", f"{d}/ms_port_{method}_2.json"]
    for n in (1, 2):
        with open(f"{d}/ms_port_{method}_{n}.json") as f:
            got = json.load(f)
        with open(f"{d}/ms_jax_{method}_{n}.json") as f:
            want = json.load(f)
        assert [r["question"] for r in got] == [r["question"] for r in want]
        assert_same_topk(*_as_arrays(got), *_as_arrays(want), 0.0 if method == "int4" else 1e-5)
    with open(f"{d}/ms_port_{method}_2.trec") as f:
        assert {line.split()[0] for line in f} == {f"q{i}" for i in range(6)}
