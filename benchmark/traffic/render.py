"""``render``: final frames on a render node.

A closed loop of one client rendering back to back. Image i is keyed
item_words(seed, i); each image is
``plutracer_tpu_torch.render.renderer.render`` of the scene at the cell's
``width``, ``height`` and ``n`` (n^2 samples a pixel) under the program's
RenderOptions built from the mix's ``options``, then
``ops.tonemap.postprocess_image``, then the copy of the tonemapped image to
host memory: render_image's path, ended where the user has the frame. An
image's time runs from the start of its render call until its copy is in
host memory.

Set-up loads the scene file through the program and compiles it on the
card (its host clock, ended by a synchronize, is the ``scene_compile``
span), then renders ``warmup`` images keyed past the window's (every
kernel built and loaded, every shape of the window run once).

Parameters (the configuration's, a mix's on top): width, height, n,
check_pixels (the pixels the check replays), warmup (1), options ({}).
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from plubench import check, spec, work
from plubench.traffic import WARMUP_KEY, percentile, sync


class Loop:
    kind = "render"

    def __init__(self, cell: spec.Cell, seed: int, device, tracer):
        self.cell, self.seed, self.device, self.tracer = cell, seed, torch.device(device), tracer
        p = cell.params
        self.width, self.height, self.n = int(p["width"]), int(p["height"]), int(p["n"])
        self.options = dict(p.get("options", {}))
        self.pix = check.sample_pixels(seed, self.width, self.height, int(p["check_pixels"]))
        self.warmup = int(p.get("warmup", 1))
        self.spans: Dict[str, float] = {}
        self.times: List[float] = []  # seconds an image
        self.linear: List[torch.Tensor] = []  # each image's checked pixels, on the device
        self.host: List[torch.Tensor] = []  # each tonemapped image in host memory
        self.attempted = self.failed = 0
        self.window_s = 0.0
        self.least_s = None  # the window's least time on the card (work.py), once counted

    def _key(self, i: int) -> torch.Tensor:
        return torch.tensor(check.item_words(self.seed, i), dtype=torch.int64)

    def setup(self) -> None:
        from plutracer_tpu_torch.ops.tonemap import postprocess_image
        from plutracer_tpu_torch.render.renderer import render
        from plutracer_tpu_torch.scene import compile_scene, load_scene_file
        from plutracer_tpu_torch.semantics import RenderOptions

        self.render, self.postprocess = render, postprocess_image
        self.render_options = RenderOptions(**self.options)
        t0 = time.perf_counter()
        desc = load_scene_file(str(spec.scene_file(self.cell.config)),
                               ["/res", f"{self.width}x{self.height}"])
        self.scene = compile_scene(desc, device=self.device)
        sync(self.device)
        self.spans["scene_compile"] = time.perf_counter() - t0
        self.pix_dev = torch.as_tensor(self.pix, device=self.device)
        for _ in range(self.warmup):
            self._image(self._key(WARMUP_KEY))
        sync(self.device)

    def _image(self, key):
        """(the checked pixels of the linear image, on the device; the
        tonemapped image in host memory). Only those pixels of the linear
        image are kept: a run that kept every image on the card would grow
        the allocator's pool image by image inside the window."""
        with self.tracer.span("render"):
            img = self.render(self.scene, self.width, self.height, self.n, key,
                              options=self.render_options)
            picked = img.reshape(-1, 3)[self.pix_dev]
        with self.tracer.span("tonemap"):
            tm = self.postprocess(img)
        with self.tracer.span("to_host"):
            host = tm.cpu()
        return picked, host

    def run(self, seconds: float) -> None:
        w0 = time.perf_counter()
        end = w0
        while time.perf_counter() - w0 < seconds:
            self.attempted += 1
            t0 = time.perf_counter()
            try:
                img, host = self._image(self._key(len(self.times)))
            except RuntimeError:
                self.failed += 1
                continue
            end = time.perf_counter()
            self.times.append(end - t0)
            self.linear.append(img)
            self.host.append(host)
        self.window_s = end - w0

    def end_to_end(self) -> Dict[str, float]:
        samples = len(self.times) * self.width * self.height * self.n * self.n
        return {"samples_per_s": samples / self.window_s,
                "image_ms.p95": 1e3 * percentile(self.times, 95)}

    def check(self, count_work: bool) -> List[check.Compared]:
        """The numbers that decide correct (check.py) of one image of the
        window drawn from the seed, with the program's state freed before
        the reference runs; count_work also counts the least time of the
        window's work (work.py) on the replayed pixels."""
        values = {"nonfinite": float(sum(int((~torch.isfinite(h)).sum()) for h in self.host))}
        if not self.times:
            return check.judged({**values, "tables_off": float("nan"),
                                 "linear_rel_l1": float("nan"), "pixels_off": float("nan"),
                                 "tonemap_gap": float("nan")}, check.RENDER_LIMITS)
        j = int(check.draw(self.seed, 0).integers(len(self.times)))
        pix = self.pix
        prog_scene = self.scene.to("cpu")
        linear, host = self.linear[j], self.host[j].reshape(-1, 3)[torch.as_tensor(pix)]
        self.scene = None
        self.linear, self.host = [], []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref_scene = check.reference_scene(spec.scene_file(self.cell.config), self.width,
                                          self.height, self.device)
        values["tables_off"] = check.tables_off(prog_scene, ref_scene)
        counted = {} if count_work else None
        opts = check.reference_options(self.options)
        ref = check.reference_pixels(ref_scene, self.width, self.height, self.n,
                                     check.item_words(self.seed, j), pix, work=counted,
                                     options=opts)
        values.update(check.pixel_numbers(linear, host, ref))
        if count_work:
            per_pixel = work.path_work(ref_scene, counted, len(pix) * self.n * self.n,
                                       bool(ref_scene.camera.lens_radius > 0))
            image = per_pixel.scaled(self.width * self.height / len(pix))
            image.bytes += work.image_bytes(self.width, self.height) + work.table_bytes(ref_scene)
            self.least_s = image.scaled(len(self.times)).least_s()
        return check.judged(values, check.RENDER_LIMITS)
