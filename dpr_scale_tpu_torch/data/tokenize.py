"""Host-side tokenization (HF fast tokenizers stay on CPU).

The port's copy of ``dpr_scale_tpu/data/tokenize.py``: the same ids and
masks for the same texts. Unlike the reference's ``HFTransform``
(dpr_scale/transforms/hf_transform.py:11-37), which pads to the longest
sequence in each batch, batches are padded to a *fixed* ``max_seq_len`` so
every device batch has one shape. (Optional length bucketing via
``pad_to_multiple``.)
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np


class HFTokenizer:
    """Thin wrapper over a HuggingFace fast tokenizer producing numpy batches.

    Thread safety: HF *fast* tokenizers wrap a Rust object whose
    truncation/padding settings are mutated per call under a RefCell
    borrow — two threads calling the same instance race to
    ``RuntimeError: Already borrowed`` (e.g. the train-batch prefetch
    thread vs the eval-batch prefetch thread at a mid-epoch validation).
    Each OS thread therefore gets its OWN underlying tokenizer, built
    lazily from ``model_path``; the wrapper object itself stays shared
    and cheap to pass around.
    """

    def __init__(
        self,
        model_path: str,
        max_seq_len: int = 256,
        add_special_tokens: bool = True,
        pad_to_multiple: int = 0,
    ):
        """``pad_to_multiple > 0`` enables length bucketing: each batch is
        padded to the longest sequence rounded up to the next multiple,
        capped at ``max_seq_len``. This recovers most of the reference's
        longest-in-batch padding economics (hf_transform.py:33) while
        keeping the number of distinct batch shapes bounded by
        ``max_seq_len / pad_to_multiple``. 0 = always pad to
        ``max_seq_len`` (one shape)."""
        self.model_path = model_path
        self.max_seq_len = max_seq_len
        self.add_special_tokens = add_special_tokens
        self.pad_to_multiple = pad_to_multiple
        self._tls = threading.local()
        # eager load on the constructing thread so a bad path fails here,
        # not inside a prefetch worker
        self._load_for_this_thread()

    def _load_for_this_thread(self):
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(self.model_path, use_fast=True)
        self._tls.tok = tok
        return tok

    @property
    def tokenizer(self):
        """The per-thread underlying HF tokenizer (see class docstring)."""
        tok = getattr(self._tls, "tok", None)
        if tok is None:
            tok = self._load_for_this_thread()
        return tok

    @property
    def spec(self) -> dict:
        """Constructor kwargs for rebuilding in a worker process (the
        wrapper holds a ``threading.local`` and cannot be pickled)."""
        return {
            "model_path": self.model_path,
            "max_seq_len": self.max_seq_len,
            "add_special_tokens": self.add_special_tokens,
            "pad_to_multiple": self.pad_to_multiple,
        }

    @property
    def sep_token(self) -> str:
        return self.tokenizer.sep_token or "[SEP]"

    @property
    def pad_token_id(self) -> int:
        return self.tokenizer.pad_token_id or 0

    def __call__(
        self,
        texts: Sequence[str],
        text_pairs: Optional[Sequence[str]] = None,
        max_seq_len: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenize to (ids, attention_mask) int32 arrays — fixed shape, or
        bucketed when ``pad_to_multiple`` is set."""
        msl = max_seq_len or self.max_seq_len
        bucketed = self.pad_to_multiple > 0
        enc = self.tokenizer(
            list(texts),
            text_pair=list(text_pairs) if text_pairs is not None else None,
            add_special_tokens=self.add_special_tokens,
            truncation=True,
            max_length=msl,
            padding="longest" if bucketed else "max_length",
            return_attention_mask=True,
            return_token_type_ids=False,
            return_tensors="np",
        )
        ids = enc["input_ids"].astype(np.int32)
        mask = enc["attention_mask"].astype(np.int32)
        if bucketed:
            m = self.pad_to_multiple
            target = min(msl, -(-ids.shape[1] // m) * m)
            pad = target - ids.shape[1]
            if pad > 0:
                ids = np.pad(
                    ids, ((0, 0), (0, pad)), constant_values=self.pad_token_id
                )
                mask = np.pad(mask, ((0, 0), (0, pad)), constant_values=0)
        return ids, mask

    def token_ids(self, text: str, max_seq_len: Optional[int] = None) -> List[int]:
        msl = max_seq_len or self.max_seq_len
        return self.tokenizer.encode(
            text,
            add_special_tokens=self.add_special_tokens,
            truncation=True,
            max_length=msl,
        )
