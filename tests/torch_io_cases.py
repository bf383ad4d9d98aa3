"""Datasets the port's io twins hand to DataLoader workers (numpy only, so
that a spawned worker imports nothing but numpy and the package under
test)."""
import numpy as np


class Squares:
    """(i, i * i) as float32 scalars (`tests/test_io.py`'s dataset)."""

    def __init__(self, n=20):
        self.n = n

    def __getitem__(self, i):
        return np.float32(i), np.float32(i * i)

    def __len__(self):
        return self.n


class SquareRows:
    """(an 8-wide row of i, i * i as int64) (`tests/test_shm_dataloader.py`'s
    dataset)."""

    def __len__(self):
        return 37

    def __getitem__(self, i):
        return np.full((8,), i, np.float32), np.int64(i * i)


class Bad:
    """Raises at index 5."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.zeros(2, np.float32)


class Records:
    """Dict samples of mixed dtypes (the collate function's dict, list,
    int and float branches)."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"ids": np.arange(i, i + 4, dtype=np.int64),
                "pair": [np.float32(i) / 3, i],
                "w": float(i) * 0.5}
