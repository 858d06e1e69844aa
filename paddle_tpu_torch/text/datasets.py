"""Text datasets of the port (``paddle_tpu/text/datasets.py``
counterpart): Imdb, Imikolov, UCIHousing, Movielens, Conll05 (Conll05st),
WMT14 and WMT16 as map-style datasets of numpy items.

Nothing is downloaded: each makes JAX's deterministic synthetic corpus,
bit for bit (``default_rng(salt + split)``), with the real corpus's
fields, dtypes and value ranges; a subclass that overrides the generation
reads real data.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..io.dataset import Dataset

__all__ = ["Imdb", "Imikolov", "UCIHousing", "Movielens", "Conll05",
           "Conll05st", "WMT14",
           "WMT16"]


def _rng(mode: str, salt: int) -> np.random.Generator:
    return np.random.default_rng(salt + (0 if mode == "train" else 1))


class Imdb(Dataset):
    """Binary sentiment corpus: (word-id sequence, label in {0, 1})
    (ref ``text/datasets/imdb.py``)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 cutoff: int = 150, synthetic_size: Optional[int] = None,
                 seq_len: int = 64, vocab_size: int = 5147):
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be train/test, got {mode!r}")
        self.word_idx = {f"w{i}": i for i in range(vocab_size)}
        n = synthetic_size or (2000 if mode == "train" else 500)
        rng = _rng(mode, 101)
        self.labels = rng.integers(0, 2, size=(n,)).astype(np.int64)
        # Sentiment signal: positive docs draw from the high half of the
        # vocab more often, so the synthetic task is learnable.
        self.docs = []
        for y in self.labels:
            bias = 0.75 if y else 0.25
            split = vocab_size // 2
            low = rng.integers(0, split, size=(seq_len,))
            high = rng.integers(split, vocab_size, size=(seq_len,))
            pick = rng.random(seq_len) < bias
            self.docs.append(np.where(pick, high, low).astype(np.int64))

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB-style n-gram LM tuples (ref ``text/datasets/imikolov.py``):
    each item is an n-gram of word ids, the last being the target."""

    def __init__(self, data_file: Optional[str] = None, data_type: str = "NGRAM",
                 window_size: int = 5, mode: str = "train",
                 min_word_freq: int = 50, synthetic_size: Optional[int] = None,
                 vocab_size: int = 2074):
        if data_type not in ("NGRAM", "SEQ"):
            raise ValueError(f"data_type must be NGRAM or SEQ, got {data_type}")
        self.data_type = data_type
        self.window_size = window_size
        self.word_idx = {f"w{i}": i for i in range(vocab_size)}
        n = synthetic_size or (1500 if mode == "train" else 300)
        rng = _rng(mode, 202)
        # Markov-ish stream: next word correlated with previous (learnable).
        stream = np.zeros(n + window_size, dtype=np.int64)
        stream[0] = rng.integers(0, vocab_size)
        for i in range(1, len(stream)):
            stream[i] = (stream[i - 1] * 31 + rng.integers(0, 7)) % vocab_size
        self._grams = [stream[i:i + window_size].copy() for i in range(n)]

    def __getitem__(self, idx):
        g = self._grams[idx]
        if self.data_type == "NGRAM":
            return tuple(g)
        return g[:-1], g[1:]

    def __len__(self):
        return len(self._grams)


class UCIHousing(Dataset):
    """Boston-housing regression: 13 fp32 features -> price
    (ref ``text/datasets/uci_housing.py``)."""

    FEATURE_DIM = 13

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 synthetic_size: Optional[int] = None):
        n = synthetic_size or (404 if mode == "train" else 102)
        rng = _rng(mode, 303)
        self.features = rng.standard_normal((n, self.FEATURE_DIM)) \
            .astype(np.float32)
        w = np.linspace(-1.0, 1.0, self.FEATURE_DIM).astype(np.float32)
        noise = 0.1 * rng.standard_normal(n).astype(np.float32)
        self.prices = (self.features @ w + noise).reshape(n, 1)

    def __getitem__(self, idx):
        return self.features[idx], self.prices[idx]

    def __len__(self):
        return len(self.features)


class Movielens(Dataset):
    """Rating tuples (user_id, gender, age, job, movie_id, category, title,
    rating) (ref ``text/datasets/movielens.py``)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 test_ratio: float = 0.1, rand_seed: int = 0,
                 synthetic_size: Optional[int] = None,
                 n_users: int = 6040, n_movies: int = 3952):
        n = synthetic_size or (4000 if mode == "train" else 400)
        rng = _rng(mode, 404 + rand_seed)
        self.max_user_id = n_users
        self.max_movie_id = n_movies
        users = rng.integers(1, n_users + 1, n)
        movies = rng.integers(1, n_movies + 1, n)
        # Rating correlated with (user+movie) parity for learnability.
        base = ((users + movies) % 5 + 1)
        jitter = rng.integers(-1, 2, n)
        self._rows = [(
            np.int64(u), np.int64(rng.integers(0, 2)),
            np.int64(rng.integers(1, 8)), np.int64(rng.integers(0, 21)),
            np.int64(m), np.int64(rng.integers(0, 18)),
            rng.integers(0, 5000, size=(8,)).astype(np.int64),
            np.float32(np.clip(b + j, 1, 5)),
        ) for u, m, b, j in zip(users, movies, base, jitter)]

    def __getitem__(self, idx):
        return self._rows[idx]

    def __len__(self):
        return len(self._rows)


class Conll05(Dataset):
    """SRL tuples: (word_ids, ctx_n2/n1/0/p1/p2, predicate, mark, labels)
    (ref ``text/datasets/conll05.py``)."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 synthetic_size: Optional[int] = None, seq_len: int = 30,
                 word_vocab: int = 44068, label_vocab: int = 59,
                 predicate_vocab: int = 3162):
        n = synthetic_size or (1000 if mode == "train" else 200)
        self.word_dict = {f"w{i}": i for i in range(word_vocab)}
        self.label_dict = {f"l{i}": i for i in range(label_vocab)}
        self.predicate_dict = {f"p{i}": i for i in range(predicate_vocab)}
        rng = _rng(mode, 505)
        self._rows = []
        for _ in range(n):
            words = rng.integers(0, word_vocab, seq_len).astype(np.int64)
            ctx = [np.roll(words, s) for s in (2, 1, 0, -1, -2)]
            pred_pos = rng.integers(0, seq_len)
            predicate = np.full(seq_len, rng.integers(0, predicate_vocab),
                                dtype=np.int64)
            mark = np.zeros(seq_len, dtype=np.int64)
            mark[pred_pos] = 1
            labels = rng.integers(0, label_vocab, seq_len).astype(np.int64)
            self._rows.append((words, *ctx, predicate, mark, labels))

    def __getitem__(self, idx):
        return self._rows[idx]

    def __len__(self):
        return len(self._rows)


class WMT16(Dataset):
    """Translation pairs (src ids, trg ids, trg_next ids) with <s>/<e>/<unk>
    conventions (ref ``text/datasets/wmt16.py``)."""

    BOS, EOS, UNK = 0, 1, 2

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 src_dict_size: int = 10000, trg_dict_size: int = 10000,
                 lang: str = "en", synthetic_size: Optional[int] = None,
                 seq_len: int = 20):
        if mode not in ("train", "test", "val"):
            raise ValueError(f"mode must be train/test/val, got {mode!r}")
        self.src_dict_size = src_dict_size
        self.trg_dict_size = trg_dict_size
        n = synthetic_size or {"train": 1600, "val": 320, "test": 320}[mode]
        # Distinct stream per split (val must not alias test).
        rng = np.random.default_rng(
            606 + {"train": 0, "val": 1, "test": 2}[mode])
        self._rows = []
        for _ in range(n):
            L = int(rng.integers(seq_len // 2, seq_len))
            src = rng.integers(3, src_dict_size, L).astype(np.int64)
            # Deterministic "translation": affine remap into the target vocab.
            trg_core = ((src * 7 + 13) % (trg_dict_size - 3) + 3)
            trg = np.concatenate([[self.BOS], trg_core]).astype(np.int64)
            trg_next = np.concatenate([trg_core, [self.EOS]]).astype(np.int64)
            self._rows.append((src, trg, trg_next))

    def get_dict(self, lang: str = "en", reverse: bool = False):
        size = self.src_dict_size if lang == "en" else self.trg_dict_size
        d = {"<s>": self.BOS, "<e>": self.EOS, "<unk>": self.UNK}
        d.update({f"tok{i}": i for i in range(3, size)})
        if reverse:
            return {v: k for k, v in d.items()}
        return d

    def __getitem__(self, idx):
        return self._rows[idx]

    def __len__(self):
        return len(self._rows)


class WMT14(WMT16):
    """ref text/datasets/wmt14.py — same synthetic translation-pair
    surface as WMT16 (different source corpus upstream)."""


# reference class name (paddle.text.Conll05st)
Conll05st = Conll05
