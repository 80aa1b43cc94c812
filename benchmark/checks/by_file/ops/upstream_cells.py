"""The op ``upstream_cells``, a driver found by file: a step is one
``FlwdirRaster.upstream_area()`` in cells, numpy out, on the seed's D8
raster; judged by the plain reference's upward sum of ones."""

import numpy as np
import torch

from benchmark import cells, generate, reference


class Driver(cells.Run):
    def setup(self):
        import pyflwdir_torch

        cfg, dev = self.cfg, self.device
        codes, self.ds = self.timed("generate_graph", lambda: generate.scheidegger_d8(
            cfg["shape"], cfg["d8"]["choices"], self.seed, dev))
        self.n = self.ds.numel()
        fl = self.timed("parse", lambda: pyflwdir_torch.from_array(
            codes.cpu().numpy(), ftype="d8", device=dev))
        self.timed("plan_build", lambda: fl._tile_plan().arrays())
        self.fl = fl
        self.timed("warm_up", self.step)

    def step(self):
        with self.tracer.call("upstream_cells"):
            return [self.wrap(lambda _: self.fl.upstream_area(), None, 0, [])]

    def units(self):
        return 1

    def release(self):
        del self.fl

    def judge(self, kept):
        ones = torch.ones(self.n, dtype=torch.int32, device=self.device)
        refs = reference.reference_sweeps(reference.Levels(self.ds), "up", [ones])
        out = torch.as_tensor(np.asarray(kept[0]).reshape(-1), device=self.device)
        return reference.compare_sweeps("up", [out], [0], refs, [ones])

    def layer_context(self, ctx):
        ctx.n = self.n
        ctx.bytes = {}
