"""Draw sources: what stands in for the ``torch.Generator`` of a forward
whose draws cannot come straight from one. Two kinds: the dropout keep
masks of stacked ensemble members (training/ensemble.py), drawn before the
forward, and ``RankRows``, one rank's rows (and, where a layer is split over the
model axis, columns) of each draw of a data- or tensor-parallel step
(parallel/mesh.py).

Inside ``torch.func.vmap`` no member can draw from a generator of its own:
``randomness="different"`` refuses an in-place draw on an unbatched tensor
and ``"same"`` gives every member one mask. So each member's masks are drawn
outside vmap, from that member's generator, in the order its forward
consumes them, and handed in as batched tensors; a ``DrawSource`` then
stands in for the generator that ``models/transformer.py:dropout`` reads.

``training/ensemble.py:record_keep_masks`` finds the masks' shapes and keep
probabilities by running the forward once on the meta device with a
``DrawRecorder``; ``draw_stacked_keep_masks`` then draws each member's
with the draw ``dropout`` makes from a generator (``bernoulli_`` of a
float32 tensor of the mask's shape), so member i's masks equal those of a
sequential run of its seed, bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Spec = Tuple[Tuple[int, ...], float]  # (mask shape, keep probability)


class DrawSource:
    """Hands ``dropout`` its keep masks, in order, in place of a
    ``torch.Generator``. A draw it does not cover (a mask beyond its list, or
    another kind of draw) raises, naming the draw."""

    def __init__(self, specs: Sequence[Spec] = (), masks: Sequence[torch.Tensor] = ()):
        if len(specs) != len(masks):
            raise ValueError(f"{len(specs)} mask specs for {len(masks)} masks")
        self.specs, self.masks, self.used = list(specs), list(masks), 0

    def keep_mask(self, x: torch.Tensor, keep_prob: float,
                  split_cols: bool = False) -> torch.Tensor:
        if split_cols:
            self.refuse("a dropout over model-split columns")
        i = self.used
        if i >= len(self.masks):
            raise RuntimeError(
                f"dropout draw {i} (shape {tuple(x.shape)}, keep {keep_prob}) is not "
                f"covered: the draw source holds {len(self.masks)} masks")
        shape, p = self.specs[i]
        if tuple(x.shape) != tuple(shape) or keep_prob != p:
            raise RuntimeError(
                f"dropout draw {i} is (shape {tuple(x.shape)}, keep {keep_prob}) but "
                f"the draw source's mask {i} is (shape {tuple(shape)}, keep {p})")
        self.used += 1
        return self.masks[i]

    def refuse(self, what: str):
        raise RuntimeError(f"{what} draws from a generator, which the draw source "
                           "does not cover (it holds dropout keep masks only)")

    def check_consumed(self) -> None:
        if self.used != len(self.masks):
            raise RuntimeError(f"the forward took {self.used} of the draw source's "
                               f"{len(self.masks)} dropout masks")


class DrawRecorder(DrawSource):
    """Records each dropout draw's (shape, keep probability) and hands out an
    all-kept mask on the input's device (the meta device in a dry run)."""

    def keep_mask(self, x: torch.Tensor, keep_prob: float,
                  split_cols: bool = False) -> torch.Tensor:
        if split_cols:
            self.refuse("a dropout over model-split columns")
        self.specs.append((tuple(x.shape), keep_prob))
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)


def draw_stacked_keep_masks(specs: Sequence[Spec], generators: Sequence[torch.Generator],
                            device) -> List[torch.Tensor]:
    """(N, *shape) bool masks, one a site: row i drawn from ``generators[i]``,
    member by member in site order, so each member's stream advances as in
    a sequential forward."""
    n = len(generators)
    bufs = [torch.empty((n, *shape), device=device) for shape, _ in specs]
    for i, g in enumerate(generators):
        for buf, (_, p) in zip(bufs, specs):
            buf[i].bernoulli_(p, generator=g)
    return [buf.bool() for buf in bufs]


class RankRows(DrawSource):
    """Rank r of a mesh's stand-in for the generator that every rank shares
    (seeded alike, advanced alike): each draw is made at the GLOBAL batch's
    shape (n_data times the local leading dimension) and this rank keeps its
    data rank's block of rows, so the ranks together draw exactly what one
    process draws at the global batch: the dropout masks (``keep_mask``),
    the magnitude noise, the image noise and turns and the masked-pretraining
    masks (``draw``, through data/augment.py). Every draw site's leading
    dimension is the batch. The ranks of one model group draw alike; where a
    tensor's last dimension is split over the model axis (``split_cols``:
    a column-split layer's output), the draw is n_model times as wide there
    too and each model rank keeps its block of columns."""

    def __init__(self, generator: torch.Generator, mesh):
        super().__init__()
        self.generator, self.mesh = generator, mesh

    def _global(self, shape, split_cols: bool = False) -> Tuple[int, ...]:
        shape = tuple(shape)
        if split_cols:
            shape = (*shape[:-1], self.mesh.n_model * shape[-1])
        return (self.mesh.size * shape[0], *shape[1:])

    def _local(self, full: torch.Tensor, split_cols: bool = False) -> torch.Tensor:
        full = full[self.mesh.block(full.shape[0])]
        if split_cols:
            c = full.shape[-1] // self.mesh.n_model
            full = full.narrow(-1, self.mesh.model_rank * c, c)
        return full

    def keep_mask(self, x: torch.Tensor, keep_prob: float,
                  split_cols: bool = False) -> torch.Tensor:
        full = torch.empty(self._global(x.shape, split_cols), device=x.device).bernoulli_(
            keep_prob, generator=self.generator)
        return self._local(full, split_cols).bool()

    def draw(self, fn, shape, **kwargs) -> torch.Tensor:
        """``fn(global_shape, generator=..., **kwargs)`` (``torch.randn``,
        ``torch.rand`` or a ``torch.randint`` with its bounds bound), this
        rank's rows."""
        return self._local(fn(self._global(shape), generator=self.generator, **kwargs))
