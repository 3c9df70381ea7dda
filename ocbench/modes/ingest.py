"""Ingest: a survey uploaded whole, INITIAL_PROCESSING batch after batch.

Set-up writes the configuration's survey, makes the pipeline as the runner
does with every image queued, and runs ``warm_batches`` iterates, after
which one batch decodes while the one before links and the one before that
relaxes. The survey is drawn from the traffic's ``survey_seed``, the same in
every run: the LM's work moves with any change to the images or to their
order, so a survey drawn from ``--seed`` would make the seed, not the
program, decide the time. ``--seed`` draws where on the globe the survey lies
(its first geotag, latitude within ``max_latitude``), which the program turns
into the same local frame. The JPEGs are the same for every seed, so they
are rendered once into ``SURVEY_CACHE`` inside the checkout; each run writes
only the geotags.

The window runs the same work in every run: the batches that hold the
traffic's ``window_images`` images (whole batches of the configuration's
size), iterated back to back. ``ingest_images_per_s`` is the images relaxed
for the first time in the window over the window's seconds. A queue that
runs dry before the window's last batch fails the run: that batch would
have nothing to overlap with. A traced run profiles the whole window, so its
spans, counters and device trace cover the batches that the untraced rate
covers. Each batch's host clocks (``cell.host_clocks``) go to the run's
wall seconds on standard error.
"""

from __future__ import annotations

import os
import time

from ocbench import survey as S
from ocbench.cell import HERE, Window, host_clocks, make_pipeline, sync
from ocbench.modes.common import graph_answers

SURVEY_CACHE = os.path.join(HERE, ".build", "surveys")


class _Progress:
    """The pipeline's progress callback: images relaxed so far and what is
    left in the queue."""

    def __init__(self):
        self.relaxed = set()
        self.queue = None

    def __call__(self, info):
        self.relaxed.update(info.relaxed_ids)
        self.queue = info.queue_size_remaining


def render(run, directory: str) -> S.Survey:
    """The survey in ``directory``: the traffic's survey from the cache, its
    first geotag drawn from ``--seed``."""
    t = run.traffic
    return S.cached_survey(directory, S.SurveySpec.from_config(run.config), t["survey_seed"], SURVEY_CACHE,
                           device=run.device, origin_latlon=S.draw_origin(run.seed, t["max_latitude"]))


def setup(run):
    images = os.path.join(run.workdir, "survey")
    os.makedirs(images)
    with run.phase("render_s"):
        truth = render(run, images)
    pipeline = make_pipeline(run.config, images, run.device)
    progress = _Progress()
    pipeline.step_callback = progress
    run.times["warm_batch_s"] = []
    for _ in range(run.traffic["warm_batches"]):
        t0 = time.perf_counter()
        pipeline.iterate_once()
        sync(run.device)
        run.times["warm_batch_s"].append(time.perf_counter() - t0)
    return dict(truth=truth, pipeline=pipeline, progress=progress)


def window(run, state) -> Window:
    pipeline, progress = state["pipeline"], state["progress"]
    batches = -(-run.traffic["window_images"] // run.config["pipeline"]["batch_size"])  # whole batches
    run.trace.window_start()
    before = len(progress.relaxed)
    run.times["window_batch_s"], run.times["window_batch_host"] = [], []
    t0 = time.perf_counter()
    with run.trace.profiled():
        for b in range(batches):
            if progress.queue == 0:
                raise RuntimeError(f"the survey ran out after {b} of the window's {batches} batches")
            t_batch, clocks = time.perf_counter(), host_clocks()
            pipeline.iterate_once()
            sync(run.device)
            run.times["window_batch_s"].append(time.perf_counter() - t_batch)
            run.times["window_batch_host"].append({k: v - clocks[k] for k, v in host_clocks().items()})
    elapsed = time.perf_counter() - t0
    images = len(progress.relaxed) - before
    record = dict(run.trace.snapshot(), images=images, batches=batches, window_s=elapsed)
    answers = graph_answers(pipeline, state["truth"].paths)
    answers["relaxed"] = sorted(answers["k_of_id"][i] for i in progress.relaxed)
    answers["truth"] = state["truth"]
    answers["batches"] = run.traffic["warm_batches"] + batches
    return Window(values={"ingest_images_per_s": images / elapsed}, record=record, answers=answers,
                  attempted=len(answers["nodes"]), failed=0)
