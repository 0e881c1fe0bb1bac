"""SentencePiece-based text transform (counterpart of
``datamodule/text_transform.py``).

Capability parity with the reference's (vestigial) ``TextTransform``
(reference: transforms.py:186-204 — a unigram SentencePiece tokenizer plus a
unit dictionary, imported nowhere and pointing at spm assets absent from the
repo; quirk Q4). Kept for API completeness: when the spm model and dict
exist it behaves identically (tokenize to unit ids, post-process back to
text); otherwise construction raises a clear error. The live tokenization
path is the Whisper tokenizer in ``utils/tokenizer.py``.
"""

from __future__ import annotations

import os

import numpy as np


class TextTransform:
    def __init__(self, sp_model_path: str, dict_path: str):
        if not (os.path.exists(sp_model_path) and os.path.exists(dict_path)):
            raise FileNotFoundError(
                f"TextTransform assets missing: {sp_model_path}, {dict_path} "
                "(the reference repo ships without them too — quirk Q4; use "
                "utils.tokenizer.load_tokenizer for the live path)")
        try:
            import sentencepiece
        except ImportError as e:
            raise ImportError("sentencepiece is not available in this environment") from e
        self.spm = sentencepiece.SentencePieceProcessor(model_file=sp_model_path)
        with open(dict_path, encoding="utf8") as f:
            units = f.read().splitlines()
        self.hashmap = {u.split()[0]: u.split()[-1] for u in units}
        self.token_list = ["<blank>"] + list(self.hashmap.keys()) + ["<eos>"]
        self.ignore_id = -1

    def tokenize(self, text: str) -> np.ndarray:
        tokens = self.spm.EncodeAsPieces(text)
        ids = [self.hashmap.get(t, self.hashmap.get("<unk>", "0")) for t in tokens]
        return np.asarray([int(i) for i in ids], dtype=np.int64)

    def post_process(self, token_ids: np.ndarray) -> str:
        token_ids = token_ids[token_ids != self.ignore_id]
        text = "".join(self.token_list[int(i)] for i in token_ids)
        return text.replace("<space>", " ").replace("▁", " ").strip()
