"""The port's evaluation modules (dpr_scale_tpu_torch.eval) against the JAX
package's on the same inputs: QA top-k accuracy with answer matching, and
the MS MARCO / TREC ranking metrics."""
import json

import numpy as np
import pytest

from dpr_scale_tpu.eval import msmarco as jax_msmarco
from dpr_scale_tpu.eval import qa_eval as jax_qa
from dpr_scale_tpu_torch.eval import msmarco, qa_eval

HAS_ANSWER_CASES = [
    ("The Eiffel Tower is in Paris.", ["paris"], False),
    ("The Eiffel Tower is in Paris.", ["eiffel tower"], False),
    ("The Eiffel Tower is in Paris.", ["London"], False),
    ("Beyoncé sang", ["Beyoncé"], False),  # NFD normalisation
    ("Paris", ["is"], False),  # token containment, not substring
    ("born in 1923", [r"19\d\d"], True),
    ("born in 1923", [r"(unclosed"], True),  # a bad pattern matches nothing
    ("", ["a"], False),
    ("a b c", [""], False),
]


@pytest.mark.parametrize("text,answers,regex", HAS_ANSWER_CASES)
def test_has_answers_matches_jax(text, answers, regex):
    got = qa_eval.has_answers(text, answers, qa_eval.SimpleTokenizer(), regex)
    want = jax_qa.has_answers(text, answers, jax_qa.SimpleTokenizer(), regex)
    assert got == want
    assert qa_eval.SimpleTokenizer().words(text) == jax_qa.SimpleTokenizer().words(text)


def _retrieval_json(path, rng):
    words = ["paris", "london", "tower", "river", "1923", "bridge", "city", "king"]
    rows = []
    for qi in range(12):
        answers = [str(rng.choice(words))] + (["the king"] if qi % 3 == 0 else [])
        ctxs = [{"id": str(j), "title": "t", "score": float(-j),
                 "text": " ".join(rng.choice(words + ["the"], size=6))} for j in range(8)]
        rows.append({"question": f"q{qi}", "answers": answers, "ctxs": ctxs, "id": qi})
    path.write_text(json.dumps(rows))


@pytest.mark.parametrize("regex", [False, True])
def test_evaluate_retrieval_matches_jax(tmp_path, regex, capsys):
    _retrieval_json(tmp_path / "ret.json", np.random.default_rng(3))
    args = (str(tmp_path / "ret.json"), [1, 3, 8], regex)
    got = qa_eval.evaluate_retrieval(*args, output_eval_results=str(tmp_path / "port.json"))
    want = jax_qa.evaluate_retrieval(*args, output_eval_results=str(tmp_path / "jax.json"))
    assert got == want and np.mean(got[1]) < np.mean(got[8])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    out = capsys.readouterr().out
    assert out.count("Top1\taccuracy") == 2


def test_qa_eval_main_matches_jax(tmp_path):
    _retrieval_json(tmp_path / "ret.json", np.random.default_rng(4))
    argv = ["--retrieval", str(tmp_path / "ret.json"), "--topk", "1", "5"]
    assert qa_eval.main(argv) == jax_qa.main(argv)


@pytest.fixture
def msmarco_files(tmp_path):
    (tmp_path / "qrels.tsv").write_text("1\t0\t101\t1\n2\t0\t202\t1\n3\t0\t303\t2\n3\t0\t304\t1\n")
    (tmp_path / "cand.tsv").write_text(
        "1\t101\t1\n1\t999\t2\n2\t998\t1\n2\t202\t2\n3\t997\t1\n3\t304\t2\n3\t997\t3\n")
    (tmp_path / "cand.trec").write_text(
        "1 Q0 101 1 9.0 x\n1 Q0 999 2 8.0 x\n2 Q0 998 1 9.0 x\n2 Q0 202 2 8.0 x\n"
        "3 Q0 303 1 9.0 x\n3 Q0 996 2 8.0 x\n")
    (tmp_path / "cand.json").write_text(json.dumps([
        {"id": 1, "ctxs": [{"id": "999"}, {"id": "101"}]},
        {"id": 2, "ctxs": [{"id": "202"}]},
        {"id": 4, "ctxs": [{"id": "1"}]},
    ]))
    return tmp_path


@pytest.mark.parametrize("cand", ["cand.tsv", "cand.trec", "cand.json"])
def test_msmarco_metrics_match_jax(msmarco_files, cand, capsys):
    ref, path = str(msmarco_files / "qrels.tsv"), str(msmarco_files / cand)
    got = msmarco.compute_metrics_from_files(ref, path)
    want = jax_msmarco.compute_metrics_from_files(ref, path)
    assert got == want and "MRR @10" in got
    assert msmarco.load_candidates(path) == jax_msmarco.load_candidates(path)
    assert msmarco.main([ref, path]) == jax_msmarco.main([ref, path])
    assert msmarco.main([ref]) is None


def test_trec_metrics_match_jax():
    qrels = {"q": {"a": 3, "b": 1, "c": 0}, "r": {"x": 1}}
    cands = {"q": ["b", "a", "c", "d"], "r": ["y", "x"], "s": ["z"]}
    kw = {"ndcg_cuts": (1, 3), "map_cuts": (2, 10), "recall_cuts": (1, 2, 100)}
    assert msmarco.trec_metrics(qrels, cands, **kw) == jax_msmarco.trec_metrics(qrels, cands, **kw)
    assert msmarco.quality_check({"q": ["a", "a"]}) == jax_msmarco.quality_check({"q": ["a", "a"]})
    with pytest.raises(IOError):
        msmarco.mrr_at_10({"q": {"a": 1}}, {"r": ["a"]})
