"""The cohort exchange: the all-gathers of the cohort-sharded trainer.

Each rank holds the rows [offset, offset + rows) of every stacked
(C, ...) client leaf.  :meth:`CohortExchange.gather_rows` packs the
leaves of a tree into one buffer of 4-byte words, runs ONE list
``all_gather`` over the group (gloo or NCCL: gloo's
``all_gather_into_tensor`` is not relied on) and unpacks each leaf as
the (world * rows, ...) concatenation in rank order, which is the
global (C, ...) leaf.  The bytes that cross the group are those of the
leaves and nothing else, so a bill of "(world - 1) x the full arrays"
(the reference's interconnect convention) is exactly what moved.

Each call counts one collective and its bytes under a label.  With gloo
a CUDA buffer is staged through host memory, so each collective is a
host round trip: the counts say how many a round makes.
"""
from __future__ import annotations

from collections import defaultdict

import torch
import torch.distributed as dist

from repro_torch.weights import tree_leaves, tree_unflatten


def _words(t: torch.Tensor) -> torch.Tensor:
    if t.element_size() != 4:
        raise TypeError(f"the cohort exchange moves 4-byte leaves, not "
                        f"{t.dtype}")
    return t.contiguous().reshape(-1).view(torch.int32)


class CohortExchange:
    def __init__(self, mesh):
        self.group = mesh.group
        self.world = mesh.world
        self.rank = mesh.rank
        self.collectives = defaultdict(int)     # label -> all-gathers
        self.bytes = defaultdict(int)           # label -> bytes moved

    def gather_rows(self, tree, label: str):
        """Every leaf (rows, ...) of this rank -> (world * rows, ...), the
        ranks' rows in rank order; one all-gather."""
        leaves = tree_leaves(tree)
        words = [_words(l) for l in leaves]
        buf = torch.cat(words) if len(words) > 1 else words[0]
        out = torch.empty((self.world, buf.numel()), dtype=torch.int32,
                          device=buf.device)
        dist.all_gather(list(out.unbind(0)), buf, group=self.group)
        self.collectives[label] += 1
        # every rank receives the other ranks' buffers
        self.bytes[label] += (self.world - 1) * self.world * buf.numel() * 4
        full, a = [], 0
        for l, w in zip(leaves, words):
            b = a + w.numel()
            full.append(out[:, a:b].view(l.dtype).reshape(
                (self.world * l.shape[0],) + tuple(l.shape[1:])))
            a = b
        return tree_unflatten(tree, full)

    def sum_over_ranks(self, tensors, label: str):
        """Each tensor summed over the ranks, in rank order (so every rank
        gets the same bits); one all-gather for all of them."""
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        tot = self.gather_rows({"x": flat}, label)["x"].reshape(
            self.world, -1).sum(0)
        out, a = [], 0
        for t in tensors:
            out.append(tot[a:a + t.numel()].reshape(t.shape))
            a += t.numel()
        return out

    def reset(self):
        self.collectives.clear()
        self.bytes.clear()
