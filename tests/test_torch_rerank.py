"""The port's rerank CLI (``cli.rerank`` -> ``retrieve.rerank``) against the
JAX package's for all three ``rerank_type``s, on the CPU.

The JAX CLI draws its weights from ``PRNGKey(0)`` (its ``restore``); the
test draws the same Flax tree and hands it to the port as a ``.npz``
through ``task.checkpoint_path``. A 2-layer encoder at hidden 64, fp32;
12 candidates in batches of 5 (a padded tail). Tolerances: the qid / ctx_id
pickles byte for byte, the scores within 1e-5 relative (1e-6 abs); the
TREC runs' qid, docid, rank and run-name fields equal, the scores within
2e-6 of the printed six decimals. The cross-encoder's (question, passage)
pairs tokenize token for token as JAX's.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conf")
WIDTH = ["task.model.vocab_size=32", "task.model.hidden_size=64", "task.model.num_heads=4",
         "task.model.intermediate_size=128"]
TYPES = {
    "dense": ["task.rerank_type=dense", "task.shared_model=false"],
    "multivec": ["task.type=multivec", "task.rerank_type=multivec", "task.variant=citadel",
                 "task.tok_projection_dim=8", "task.cls_projection_dim=8", "task.add_cls=true",
                 "task.context_topk=2"],
    "cross_encoder": ["task.rerank_type=cross_encoder"],
}


def _flat(tree, prefix=""):
    out = {}
    for name, child in tree.items():
        if isinstance(child, dict):
            out.update(_flat(child, f"{prefix}{name}/"))
        else:
            out[f"{prefix}{name}"] = np.asarray(child)
    return out


@pytest.fixture(scope="module")
def candidates(tmp_path_factory):
    d = tmp_path_factory.mktemp("rerank")
    rng = np.random.default_rng(11)
    words = list("abcdefghijklmnopqrst") + ["who", "what", "book", "city"]
    with open(d / "passages.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        for i in range(10):
            f.write(f"d{i}\t{' '.join(rng.choice(words, size=5))}\t{words[i]}\n")
    (d / "queries.tsv").write_text("q1\twho wrote a book\nq2\twhat city\nq3\tbook title\n")
    lines = [f"q{1 + i // 4} Q0 d{(3 * i) % 10} {i % 4 + 1} {10 - i}.0 first" for i in range(12)]
    (d / "cand.trec").write_text("\n".join(lines) + "\n")
    return d


def _jax_params(cfg_overrides, rerank_type, tiny_bert_dir):
    """The JAX CLI's restore: model.init(PRNGKey(0), dummy inputs)."""
    from dpr_scale_tpu.cli.common import build_model_config
    from dpr_scale_tpu.config import load_config
    from dpr_scale_tpu.models import BiEncoder
    from dpr_scale_tpu.models.multivec import CrossEncoder, MultiVecEncoder

    cfg = load_config(os.path.join(CONF, "tiny_smoke.yaml"), cfg_overrides)
    mcfg, t = build_model_config(cfg), cfg.task
    dummy = jnp.ones((1, cfg.task.transform.max_seq_len), jnp.int32)
    if rerank_type == "dense":
        model = BiEncoder(mcfg, projection_dim=0, shared=t.get("shared_model", True))
        args, kw = (dummy,) * 4, {}
    elif rerank_type == "multivec":
        model = MultiVecEncoder(mcfg, variant="citadel", tok_projection_dim=8,
                                cls_projection_dim=8)
        args, kw = (dummy,) * 2, dict(topk=1, add_cls=True)
    else:
        model, args, kw = CrossEncoder(mcfg), (dummy,) * 2, {}
    return jax.device_get(model.init(jax.random.PRNGKey(0), *args, **kw)["params"])


@pytest.mark.parametrize("rerank_type", list(TYPES))
def test_rerank_cli_equals_jax(candidates, tiny_bert_dir, rerank_type):
    from dpr_scale_tpu.cli import rerank as jax_rerank
    from dpr_scale_tpu_torch.cli import rerank

    d = candidates
    common = [f"task.transform.model_path={tiny_bert_dir}", *WIDTH, *TYPES[rerank_type],
              f"datamodule.trec_path={d}/cand.trec", f"datamodule.queries_path={d}/queries.tsv",
              f"datamodule.passages_path={d}/passages.tsv", "datamodule.batch_size=5"]
    np.savez(d / f"{rerank_type}.npz", **_flat(_jax_params(common, rerank_type, tiny_bert_dir)))
    outs = {}
    for side in ("jax", "port"):
        argv = ["--config", os.path.join(CONF, "tiny_smoke.yaml"), *common,
                f"task.output_trec_path={d}/{side}_{rerank_type}.trec",
                f"task.output_pickle_dir={d}/{side}_{rerank_type}"]
        if side == "jax":
            outs[side] = jax_rerank.main(argv)
        else:
            outs[side] = rerank.main(argv[:2] + ["--device", "cpu"] + argv[2:] + [
                f"task.checkpoint_path={d}/{rerank_type}.npz"])
    want, got = outs["jax"], outs["port"]
    assert len(got["scores"]) == len(want["scores"]) == 12
    assert np.isfinite(got["scores"]).all() and len(set(got["scores"])) > 6
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
    for name in ("qids", "ctx_ids"):
        port_bytes = open(f"{d}/port_{rerank_type}/{name}_0000.pkl", "rb").read()
        assert port_bytes == open(f"{d}/jax_{rerank_type}/{name}_0000.pkl", "rb").read()
    with open(f"{d}/port_{rerank_type}/scores_0000.pkl", "rb") as f:
        assert pickle.load(f) == got["scores"]
    rows = {side: [l.split() for l in open(f"{d}/{side}_{rerank_type}.trec")]
            for side in ("jax", "port")}
    assert [r[:4] + r[5:] for r in rows["port"]] == [r[:4] + r[5:] for r in rows["jax"]]
    np.testing.assert_allclose([float(r[4]) for r in rows["port"]],
                               [float(r[4]) for r in rows["jax"]], rtol=1e-5, atol=2e-6)


def test_cross_encoder_pairs_tokenize_as_jax(candidates, tiny_bert_dir):
    from dpr_scale_tpu.data.datasets import IDCSVDataset as JaxIDCSV
    from dpr_scale_tpu.data.datasets import QueryTRECDataset as JaxQueries
    from dpr_scale_tpu.data.datasets import TRECCandidateDataset as JaxCandidates
    from dpr_scale_tpu.data.tokenize import HFTokenizer as JaxTokenizer
    from dpr_scale_tpu.retrieve.rerank import _pair_batches as jax_pairs
    from dpr_scale_tpu_torch.data.datasets import IDCSVDataset, QueryTRECDataset, TRECCandidateDataset
    from dpr_scale_tpu_torch.data.tokenize import HFTokenizer
    from dpr_scale_tpu_torch.retrieve.rerank import _pair_batches

    d = candidates
    port = TRECCandidateDataset(f"{d}/cand.trec", QueryTRECDataset(f"{d}/queries.tsv"),
                                IDCSVDataset(f"{d}/passages.tsv"))
    ref = JaxCandidates(f"{d}/cand.trec", JaxQueries(f"{d}/queries.tsv"),
                        JaxIDCSV(f"{d}/passages.tsv"))
    assert [port[i] for i in range(len(port))] == [ref[i] for i in range(len(ref))]
    for concat in (True, False):
        got = list(_pair_batches(port, HFTokenizer(tiny_bert_dir, max_seq_len=16), 5, concat, True))
        want = list(jax_pairs(ref, JaxTokenizer(tiny_bert_dir, max_seq_len=16), 5, concat, True))
        assert [p for _i, p, _b in got] == [p for _i, p, _b in want] == [0, 0, 3]
        for (_i, _p, g), (_j, _q, w) in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                assert g[key].dtype == w[key].dtype and g[key].tobytes() == w[key].tobytes()
