"""QA retrieval accuracy: answer-string matching over retrieved passages.

Behavior parity with reference dpr_scale/eval_dpr.py (:166-276): unicode
NFD normalization, simple-regex tokenization with uncased token-sequence
containment (or regex-pattern matching with --regex), and top-k accuracy
where a question counts for k if any of its first-k passages contains an
answer. Pure Python, no accelerator dependency: the port's copy of
``dpr_scale_tpu.eval.qa_eval`` (the port imports nothing of the JAX
package), the acceptance test for retrieval outputs (SURVEY.md §4).

    python -m dpr_scale_tpu_torch.eval.qa_eval --retrieval retrieval.json --topk 1 5 20 100
"""
from __future__ import annotations

import argparse
import json
import re
import unicodedata
from typing import Dict, List, Sequence

import numpy as np
import regex as regex_mod


class SimpleTokenizer:
    """Unicode alphanumeric / non-whitespace tokenizer (eval_dpr.py:166-205)."""

    ALPHA_NUM = r"[\p{L}\p{N}\p{M}]+"
    NON_WS = r"[^\p{Z}\p{C}]"

    def __init__(self):
        self._regexp = regex_mod.compile(
            f"({self.ALPHA_NUM})|({self.NON_WS})",
            flags=regex_mod.IGNORECASE + regex_mod.UNICODE + regex_mod.MULTILINE,
        )

    def words(self, text: str, uncased: bool = True) -> List[str]:
        tokens = [m.group() for m in self._regexp.finditer(text)]
        return [t.lower() for t in tokens] if uncased else tokens


def _normalize(text: str) -> str:
    return unicodedata.normalize("NFD", text)


def regex_match(text: str, pattern: str) -> bool:
    try:
        compiled = re.compile(pattern, flags=re.IGNORECASE | re.UNICODE | re.MULTILINE)
    except re.error:
        return False
    return compiled.search(text) is not None


def has_answers(
    text: str,
    answers: Sequence[str],
    tokenizer: SimpleTokenizer,
    regex: bool = False,
) -> bool:
    text = _normalize(text)
    if regex:
        return any(regex_match(text, _normalize(a)) for a in answers)
    words = tokenizer.words(text)
    for ans in answers:
        ans_words = tokenizer.words(_normalize(ans))
        n = len(ans_words)
        if n == 0:
            continue
        for i in range(len(words) - n + 1):
            if words[i : i + n] == ans_words:
                return True
    return False


def evaluate_retrieval(
    retrieval_file: str,
    topk: Sequence[int],
    regex: bool = False,
    output_eval_results: str = "",
) -> Dict[int, List[int]]:
    """Top-k accuracy per question; prints per-k means like the reference."""
    tokenizer = SimpleTokenizer()
    with open(retrieval_file) as f:
        retrieval = json.load(f)
    accuracy: Dict[int, List[int]] = {k: [] for k in topk}
    max_k = max(topk)
    annotate = bool(output_eval_results)

    for question in retrieval:
        answers = question["answers"]
        first_hit = max_k
        for idx, ctx in enumerate(question["ctxs"]):
            if idx >= max_k:
                break
            hit = has_answers(ctx["text"], answers, tokenizer, regex)
            if annotate:
                ctx["has_answer"] = hit
            if hit:
                first_hit = min(first_hit, idx)
                if not annotate:
                    break
        for k in topk:
            accuracy[k].append(1 if first_hit < k else 0)

    print("Evaluating", retrieval_file)
    for k in topk:
        print(f"Top{k}\taccuracy: {np.mean(accuracy[k])}")
    if output_eval_results:
        with open(output_eval_results, "w") as f:
            json.dump(retrieval, f, indent=4)
    return accuracy


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--retrieval", type=str, required=True)
    parser.add_argument("--topk", type=int, nargs="+", default=[1, 5, 10, 20, 50, 100])
    parser.add_argument("--regex", action="store_true", default=False)
    parser.add_argument("--output_eval_results", type=str, default="")
    args = parser.parse_args(argv)
    return evaluate_retrieval(
        args.retrieval, args.topk, args.regex, args.output_eval_results
    )


if __name__ == "__main__":
    main()
