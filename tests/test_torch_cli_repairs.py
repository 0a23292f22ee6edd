"""Two faults of the port's dense CLIs against the JAX package's, on the CPU:

* C9: ``generate_embeddings``, ``generate_query_embeddings``,
  ``run_retrieval`` and ``serve`` built a CLS ``BiEncoder`` whatever
  ``task.model.family`` said, so a SPLADE export failed to load (and without
  a checkpoint they wrote hidden-size vectors). They now build
  ``SpladeBiEncoder`` for ``splade``, as the JAX CLIs do through their task:
  the same (N, vocab) vectors, top-k and ``/search`` answers as the JAX CLIs
  on the same weights;
* C10: ``generate_embeddings`` had no ``--queries`` flag; with it the port
  writes the ``query_reps.pkl`` the JAX CLI writes, and refuses it with an
  exported encoder, as JAX does.

The JAX CLIs run from their seeded init (``PRNGKey(0)``); the port reads
the same Flax tree as a ``.npz`` through ``task.checkpoint_path``. A 2-layer
encoder at hidden 64, fp32. Tolerances: vectors within 1e-5 abs / 1e-4
rel, the same top-k ids and scores within 1e-4 rel.
"""
import json
import os
import pickle

import numpy as np
import pytest

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
WORDS = list("abcdefghijklmnopqrst") + ["who", "what", "book", "city"]
N_PASSAGES, N_QUERIES, K = 24, 8, 5


def _flat(tree, prefix=""):
    out = {}
    for name, child in tree.items():
        key = f"{prefix}{name}"
        if isinstance(child, dict):
            out.update(_flat(child, key + "/"))
        else:
            out[key] = np.asarray(child)
    return out


@pytest.fixture(scope="module")
def splade(tmp_path_factory, tiny_bert_dir):
    """Passages, questions, the common overrides and the JAX task's seeded
    SPLADE params saved as a .npz for the port."""
    import jax

    from dpr_scale_tpu.cli.common import build_task, build_tokenizer
    from dpr_scale_tpu.cli.generate_embeddings import _init_params
    from dpr_scale_tpu.config import load_config as jax_load_config

    d = tmp_path_factory.mktemp("splade_cli")
    rng = np.random.default_rng(5)
    with open(d / "passages.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        for i in range(N_PASSAGES):
            f.write(f"p{i}\t{' '.join(rng.choice(WORDS, size=6))}\t{WORDS[i % 20]}\n")
    with open(d / "questions.csv", "w") as f:
        for i in range(N_QUERIES):
            f.write(f"{' '.join(rng.choice(WORDS, size=3))}\t{[WORDS[i]]}\n")
    common = [f"task.transform.model_path={tiny_bert_dir}", "task.model.vocab_size=32",
              "task.model.family=splade", "task.model.hidden_size=64", "task.model.num_heads=4",
              "task.model.intermediate_size=128", f"datamodule.passages_path={d}/passages.tsv",
              f"datamodule.test_path={d}/questions.csv", "datamodule.encode_batch_size=8",
              f"task.topk={K}", "task.query_batch=8", "task.mips_method=exact_sort"]
    cfg = jax_load_config(os.path.join(CONF, "tiny_smoke.yaml"), common)
    task = build_task(cfg)
    params = _init_params(task, build_tokenizer(cfg), None)
    np.savez(d / "splade.npz", **_flat(jax.device_get(params)))
    return d, common


def _argv(common, *extra, port=False, flags=()):
    head = ["--config", os.path.join(CONF, "tiny_smoke.yaml"), *flags]
    return head + (["--device", "cpu"] if port else []) + common + list(extra)


def _load(path):
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f))


def test_splade_encode_retrieve_and_search_equal_jax(splade):
    """C9: fails on a port whose CLIs build a CLS BiEncoder (the SPLADE
    export's mlm_head keys do not load)."""
    from dpr_scale_tpu.cli import generate_embeddings as jax_gen
    from dpr_scale_tpu.cli import run_retrieval as jax_run
    from dpr_scale_tpu_torch.cli import generate_embeddings, run_retrieval, serve
    from dpr_scale_tpu_torch.config import load_config

    d, common = splade
    ckpt = f"task.checkpoint_path={d}/splade.npz"
    jax_gen.main(_argv(common, f"task.ctx_embeddings_dir={d}/jax"))
    generate_embeddings.main(_argv(common, ckpt, f"task.ctx_embeddings_dir={d}/port", port=True))
    want, got = _load(f"{d}/jax/reps_0000.pkl"), _load(f"{d}/port/reps_0000.pkl")
    assert got.shape == want.shape == (N_PASSAGES, 32)  # vocab-sized, not hidden-sized
    assert (got > 0).any() and (got >= 0).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)

    runs = {}
    for side, run, extra in (("jax", jax_run.main, []), ("port", run_retrieval.main, [ckpt])):
        out = f"{d}/{side}.json"
        run(_argv(common, *extra, f"task.ctx_embeddings_dir={d}/{side}",
                  f"task.output_path={out}", port=side == "port"))
        with open(out) as f:
            runs[side] = [[(c["id"], c["score"]) for c in row["ctxs"]] for row in json.load(f)]
    for g, w in zip(runs["port"], runs["jax"]):
        assert [i for i, _s in g] == [i for i, _s in w]
        np.testing.assert_allclose([s for _i, s in g], [s for _i, s in w], rtol=1e-4, atol=1e-6)

    cfg = load_config(os.path.join(CONF, "tiny_smoke.yaml"),
                      common + [ckpt, f"task.ctx_embeddings_dir={d}/port", "serve.method=exact_sort"])
    retriever = serve.build_retriever(cfg, device="cpu")
    with open(f"{d}/port.json") as f:
        questions = [row["question"] for row in json.load(f)]
    served = retriever.search(questions, k=K)
    for g, w in zip(served, runs["jax"]):
        assert [c["id"] for c in g] == [i for i, _s in w]
        np.testing.assert_allclose([c["score"] for c in g], [s for _i, s in w], rtol=1e-4,
                                   atol=1e-6)


def test_generate_embeddings_queries_equals_jax(splade):
    """C10: ``--queries`` routes to the query encoder (argparse refused the
    flag before); with an exported encoder both packages refuse it."""
    from dpr_scale_tpu.cli import generate_embeddings as jax_gen
    from dpr_scale_tpu_torch.cli import generate_embeddings

    d, common = splade
    q = ["--queries"]
    jax_gen.main(_argv(common, f"task.ctx_embeddings_dir={d}/jq", flags=q))
    path = generate_embeddings.main(_argv(common, f"task.checkpoint_path={d}/splade.npz",
                                          f"task.ctx_embeddings_dir={d}/pq", port=True, flags=q))
    assert path == f"{d}/pq/query_reps.pkl"
    want, got = _load(f"{d}/jq/query_reps.pkl"), _load(path)
    assert got.dtype == np.float32 and got.shape == want.shape == (N_QUERIES, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    for main, port in ((jax_gen.main, False), (generate_embeddings.main, True)):
        with pytest.raises(ValueError, match="--queries with task.exported_encoder_path"):
            main(_argv(common, f"task.exported_encoder_path={d}/none",
                       f"task.ctx_embeddings_dir={d}/x", port=port, flags=q))
