"""The port's retrieval CLI path on the CPU at a tiny size, held against the JAX
package: ``generate_query_embeddings`` -> ``run_retrieval`` -> DPR JSON /
TREC, for every ported MIPS method.

Given the same shards and the same ``query_reps.pkl``, both CLIs must return
the same passages in the same order for every question; the scores are fp32
sums of the same bf16 products taken in other orders, so they agree within
1e-5 relative (the TREC file prints six decimals).
"""
import json
import os
import pickle

import numpy as np
import pytest

from dpr_scale_tpu.encode.embeddings import load_embedding_shard as jax_load_shard
from dpr_scale_tpu_torch.cli import generate_query_embeddings, run_retrieval
from dpr_scale_tpu_torch.encode.embeddings import save_embedding_shard
from dpr_scale_tpu_torch.retrieve.retrieval import build_index, retrieve

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
WORDS = list("abcdefghij") + ["who", "what", "book", "city", "text", "title"]
METHODS = ["fused", "groupmax", "auto", "approx", "exact_sort"]
N_PASSAGES, N_QUERIES, DIM, TOPK = 60, 10, 16, 7


@pytest.fixture(scope="module")
def setup(tmp_path_factory, tiny_bert_dir):
    d = tmp_path_factory.mktemp("torch_retrieval_cli")
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
    save_embedding_shard(str(embs / "reps_0000"), corpus[:35], "pickle")
    save_embedding_shard(str(embs / "reps_0001"), corpus[35:], "npy")
    qpath = d / "query_vectors.pkl"
    with open(qpath, "wb") as f:
        pickle.dump(rng.normal(size=(N_QUERIES, DIM)).astype(np.float32), f, protocol=4)
    common = [
        "--config", os.path.join(CONF, "tiny_smoke.yaml"),
        f"task.transform.model_path={tiny_bert_dir}", "task.model.vocab_size=32",
        f"datamodule.passages_path={d}/passages.tsv", f"datamodule.test_path={d}/questions.csv",
        f"task.ctx_embeddings_dir={embs}", f"task.topk={TOPK}",
        "task.query_batch=4",  # 10 queries: the last batch is padded
    ]
    return d, common, str(qpath)


def _run_both(d, common, qpath, method, extra=()):
    outs = {}
    for side in ("jax", "port"):
        out = [f"task.query_emb_path={qpath}", f"task.mips_method={method}",
               f"task.output_path={d}/{side}_{method}.json",
               f"task.output_trec_path={d}/{side}_{method}.trec", *extra]
        if side == "jax":
            from dpr_scale_tpu.cli import run_retrieval as jax_run_retrieval

            jax_run_retrieval.main(common + out)
        else:
            run_retrieval.main(common[:2] + ["--device", "cpu"] + common[2:] + out)
        with open(f"{d}/{side}_{method}.json") as f:
            payload = json.load(f)
        with open(f"{d}/{side}_{method}.trec") as f:
            trec = [line.split() for line in f]
        outs[side] = payload, trec
    return outs["jax"], outs["port"]


@pytest.mark.parametrize("method", METHODS)
def test_run_retrieval_matches_the_jax_cli(setup, method):
    d, common, qpath = setup
    (want, want_trec), (got, got_trec) = _run_both(d, common, qpath, method)
    assert len(got) == len(want) == N_QUERIES
    for g, w in zip(got, want):
        assert (g["question"], g["answers"], g["id"]) == (w["question"], w["answers"], w["id"])
        assert [c["id"] for c in g["ctxs"]] == [c["id"] for c in w["ctxs"]]
        assert len(g["ctxs"]) == TOPK
        for gc, wc in zip(g["ctxs"], w["ctxs"]):
            assert (gc["title"], gc["text"]) == (wc["title"], wc["text"])
        np.testing.assert_allclose([c["score"] for c in g["ctxs"]],
                                   [c["score"] for c in w["ctxs"]], rtol=1e-5, atol=1e-6)
    assert [r[:4] + r[5:] for r in got_trec] == [r[:4] + r[5:] for r in want_trec]
    np.testing.assert_allclose([float(r[4]) for r in got_trec], [float(r[4]) for r in want_trec],
                               rtol=1e-5, atol=2e-6)


def test_generate_query_embeddings_matches_jax(setup):
    """Same weights through the bridge (fp32, dropout 0, the tiny preset's
    hidden 16): the port's query_reps.pkl equals the JAX encoder's within
    1e-5 and the JAX loader reads it."""
    from dpr_scale_tpu.cli.common import build_task, build_tokenizer
    from dpr_scale_tpu.cli.generate_embeddings import _init_params
    from dpr_scale_tpu.cli.generate_query_embeddings import encode_queries as jax_encode_queries
    from dpr_scale_tpu.config import load_config as jax_load_config
    from dpr_scale_tpu_torch.cli.common import build_biencoder
    from dpr_scale_tpu_torch.cli.common import build_tokenizer as port_tokenizer
    from dpr_scale_tpu_torch.config import load_config
    from dpr_scale_tpu_torch.models.convert import from_jax_params

    d, common, _qpath = setup
    argv = common[2:] + [f"task.ctx_embeddings_dir={d}/qemb", "datamodule.encode_batch_size=4"]
    jcfg = jax_load_config(common[1], argv + [f"task.query_emb_output_path={d}/jax_q.pkl"])
    tok = build_tokenizer(jcfg)
    task = build_task(jcfg)
    params = _init_params(task, tok, None)
    jax_encode_queries(jcfg, task, params, tok, f"{d}/qemb")

    cfg = load_config(common[1], argv)
    model = build_biencoder(cfg, "cpu")
    model.load_state_dict(from_jax_params(params))
    path = generate_query_embeddings.encode_queries(
        cfg, model, port_tokenizer(cfg), "cpu", f"{d}/qemb")
    assert path == f"{d}/qemb/query_reps.pkl"
    got, want = jax_load_shard(path), jax_load_shard(f"{d}/jax_q.pkl")
    assert got.dtype == np.float32 and got.shape == want.shape == (N_QUERIES, DIM)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    # the CLI from seeded weights writes the same layout
    seeded = generate_query_embeddings.main(["--config", common[1], "--device", "cpu"] + argv)
    assert seeded == path and jax_load_shard(seeded).shape == (N_QUERIES, DIM)


def test_run_retrieval_encodes_queries_when_no_pickle_exists(setup, tmp_path):
    """Without query_reps.pkl the CLI encodes the questions itself: the same
    results as from the pickle generate_query_embeddings writes."""
    d, common, _qpath = setup
    embs = tmp_path / "embs"
    embs.mkdir()
    rng = np.random.default_rng(1)
    save_embedding_shard(str(embs / "reps_0000"), rng.normal(size=(N_PASSAGES, DIM)).astype(
        np.float32), "pickle")
    argv = ["--config", common[1], "--device", "cpu"] + common[2:] + [
        f"task.ctx_embeddings_dir={embs}"]
    encoded = run_retrieval.main(argv)
    generate_query_embeddings.main(argv)
    assert (embs / "query_reps.pkl").exists()
    loaded = run_retrieval.main(argv)
    assert [[c["id"] for c in r] for r in encoded] == [[c["id"] for c in r] for r in loaded]
    np.testing.assert_allclose([[c["score"] for c in r] for r in encoded],
                               [[c["score"] for c in r] for r in loaded], rtol=1e-5)


def test_retrieve_empty_query_set_matches_jax(setup):
    from dpr_scale_tpu.parallel import get_mesh
    from dpr_scale_tpu.retrieve.retrieval import retrieve as jax_retrieve

    d, _common, _qpath = setup
    for side, fn, where in (("jax", jax_retrieve, get_mesh(1)), ("port", retrieve, "cpu")):
        out = fn(np.zeros((0, DIM), np.float32), [], f"{d}/passages.tsv", f"{d}/embs", where,
                 output_json_path=f"{d}/empty_{side}.json",
                 output_trec_path=f"{d}/empty_{side}.trec")
        assert out == []
    for ext in ("json", "trec"):
        with open(f"{d}/empty_port.{ext}") as a, open(f"{d}/empty_jax.{ext}") as b:
            assert a.read() == b.read()


def test_retrieve_passes_ignore_identical_ids_through(setup):
    """A query whose id names a passage drops it from the TREC run only."""
    d, _common, qpath = setup
    with open(qpath, "rb") as f:
        q = pickle.load(f)[:2]
    index = build_index(f"{d}/embs", "cpu", method="exact_sort")
    top = index.search(q, 1)[1][:, 0]
    questions = [{"question": "x", "id": f"p{top[0]}"}, {"question": "y", "id": "q1"}]
    for flag in (False, True):
        results = retrieve(q, questions, f"{d}/passages.tsv", f"{d}/embs", index=index, k=3,
                           output_trec_path=f"{d}/ident_{flag}.trec", ignore_identical_ids=flag)
        assert results[0][0]["id"] == f"p{top[0]}"
        with open(f"{d}/ident_{flag}.trec") as f:
            docs = [line.split()[2] for line in f if line.startswith(f"p{top[0]} ")]
        assert (f"p{top[0]}" in docs) != flag


@pytest.mark.parametrize("option,value", [
    ("task.host_resident_index", "true"), ("task.index_store", "/tmp/store"),
    ("task.device_rows", "100"), ("task.rerank_oversample", "4"),
    ("task.int8_query_planes", "2"), ("task.mips_method", "int8"),
])
def test_unported_tiers_raise_naming_a9(setup, option, value):
    """Every tier is ported now and acts as in the JAX CLI. The host-resident
    tiers (ROADMAP A1, which raised until they were ported):
    ``host_resident_index`` streams the fused index's blocks from the host,
    ``device_rows`` without a store changes nothing, and ``index_store``
    refuses a method other than int8 on both sides, then with int8 builds a
    store byte-equal to the JAX CLI's and answers as it does. The quantised
    options act on the default ``fused`` index: a rerank there raises
    ValueError on both sides, the query planes change nothing; ``int8``
    answers as the JAX CLI does (tests/test_torch_int_cli.py holds the
    tiers in full)."""
    d, common, qpath = setup
    extra = [f"task.query_emb_path={qpath}", f"{option}={value}"]
    if option == "task.index_store":
        from dpr_scale_tpu.cli import run_retrieval as jax_run_retrieval

        for main, argv in ((jax_run_retrieval.main, common + extra),
                           (run_retrieval.main, common[:2] + ["--device", "cpu"] + common[2:]
                            + extra)):
            with pytest.raises(ValueError, match="index_store requires mips_method=int8"):
                main(argv)
        stores = {side: f"{d}/store_{side}" for side in ("jax", "port")}
        outs = {}
        for side, main, argv in (
                ("jax", jax_run_retrieval.main, common),
                ("port", run_retrieval.main, common[:2] + ["--device", "cpu"] + common[2:])):
            main(argv + [f"task.query_emb_path={qpath}", "task.mips_method=int8",
                         f"task.index_store={stores[side]}", "task.device_rows=0",
                         f"task.output_trec_path={d}/{side}_store.trec"])
            with open(f"{d}/{side}_store.trec") as f:
                outs[side] = [line.split() for line in f]
        for name in sorted(os.listdir(stores["jax"])):
            with open(f"{stores['jax']}/{name}", "rb") as a, open(f"{stores['port']}/{name}",
                                                                  "rb") as b:
                assert a.read() == b.read(), name
        assert [r[:4] for r in outs["port"]] == [r[:4] for r in outs["jax"]]
        np.testing.assert_allclose([float(r[4]) for r in outs["port"]],
                                   [float(r[4]) for r in outs["jax"]], rtol=1e-5)
        return
    if option in ("task.host_resident_index", "task.device_rows"):
        (want, want_trec), (got, got_trec) = _run_both(d, common, qpath, "fused",
                                                       [f"{option}={value}"])
        assert [r[:4] for r in got_trec] == [r[:4] for r in want_trec]
        for g, w in zip(got, want):
            assert [c["id"] for c in g["ctxs"]] == [c["id"] for c in w["ctxs"]]
        return
    if option == "task.rerank_oversample":
        from dpr_scale_tpu.cli import run_retrieval as jax_run_retrieval

        for main, argv in ((jax_run_retrieval.main, common + extra),
                           (run_retrieval.main, common[:2] + ["--device", "cpu"] + common[2:]
                            + extra)):
            with pytest.raises(ValueError, match="lossy"):
                main(argv)
        return
    method = "int8" if option == "task.mips_method" else "fused"
    (want, _), (got, _) = _run_both(d, common, qpath, method, [f"{option}={value}"])
    for g, w in zip(got, want):
        scores = [c["score"] for c in g["ctxs"]]
        np.testing.assert_allclose(scores, [c["score"] for c in w["ctxs"]], rtol=1e-5)
        clear = [c["id"] for c in g["ctxs"] if c["score"] > scores[-1] + 1e-5 * abs(scores[-1])]
        assert clear == [c["id"] for c in w["ctxs"][: len(clear)]]
