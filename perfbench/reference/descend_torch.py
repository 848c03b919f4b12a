"""The reference descent in plain PyTorch, for the lower-precision control.

The control stands in for the program under test: it classifies the batch it
is handed on the card, with the records rounded to bfloat16 (the precision
below the configuration's float32, as a kernel that read its frames in
bfloat16 to halve their bytes would) and the thresholds kept in float32.
Its classes must fail the check; ``perfbench/control.py`` runs it.
"""

from __future__ import annotations

import torch


class Bf16Reference:
    def __init__(self, tables, n_classes: int, device):
        attr, thr, child, cls = (torch.from_numpy(t).to(device) for t in tables)
        self.attr, self.thr = attr.long(), thr
        self.child, self.cls = child.long(), cls.long()
        self.n_classes = n_classes
        self.device = device

    def per_tree(self, records: torch.Tensor) -> torch.Tensor:
        """(T, M) classes of ``records`` rounded to bfloat16."""
        rec = records.to(self.device).to(torch.bfloat16).to(torch.float32)
        m = rec.shape[0]
        out = []
        for t in range(self.attr.shape[0]):
            idx = torch.zeros(m, dtype=torch.long, device=self.device)
            for _ in range(self.attr.shape[1]):
                inner = self.cls[t, idx] < 0
                if not bool(inner.any()):
                    break
                val = rec.gather(1, self.attr[t, idx][:, None])[:, 0]
                nxt = self.child[t, idx] + (val > self.thr[t, idx]).long()
                idx = torch.where(inner, nxt, idx)
            out.append(self.cls[t, idx])
        return torch.stack(out)

    def __call__(self, records: torch.Tensor) -> torch.Tensor:
        per_tree = self.per_tree(records)
        if per_tree.shape[0] == 1:
            return per_tree[0].to(torch.int32)
        classes = torch.arange(self.n_classes, device=self.device)
        votes = (per_tree[..., None] == classes).sum(0)
        key = votes * self.n_classes + (self.n_classes - 1 - classes)
        return key.argmax(-1).to(torch.int32)
