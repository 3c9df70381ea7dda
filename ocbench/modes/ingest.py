"""Ingest: a survey uploaded whole, INITIAL_PROCESSING batch after batch.

Set-up renders the configuration's survey, makes the pipeline as the runner
does with every image queued, and runs ``warm_batches`` iterates,
after which one batch decodes while the one before links and the one before
that relaxes. The window runs ``iterate_once`` and closes at the batch
boundary nearest ``--seconds``: after a boundary more than half the last
batch's time short of it, it runs one batch more. ``ingest_images_per_s`` is
the images relaxed for the first time in the window over the window's time
to that boundary. A queue that runs dry inside the window fails the run: the
survey is too short for the rate. The traced run profiles the window's first
``profile_batches``.
"""

from __future__ import annotations

import os
import time

from ocbench import survey as S
from ocbench.cell import Window, make_pipeline, sync
from ocbench.modes.common import graph_answers


class _Progress:
    """The pipeline's progress callback: images relaxed so far and what is
    left in the queue."""

    def __init__(self):
        self.relaxed = set()
        self.queue = None

    def __call__(self, info):
        self.relaxed.update(info.relaxed_ids)
        self.queue = info.queue_size_remaining


def setup(run):
    spec = S.SurveySpec.from_config(run.config)
    images = os.path.join(run.workdir, "survey")
    os.makedirs(images)
    with run.phase("render_s"):
        truth = S.write_survey(images, spec, run.seed, device=run.device)
    pipeline = make_pipeline(run.config, images, run.device)
    progress = _Progress()
    pipeline.step_callback = progress
    run.times["warm_batch_s"] = []
    for _ in range(run.traffic["warm_batches"]):
        t0 = time.perf_counter()
        pipeline.iterate_once()
        run.times["warm_batch_s"].append(time.perf_counter() - t0)
    return dict(truth=truth, pipeline=pipeline, progress=progress)


def window(run, state) -> Window:
    pipeline, progress = state["pipeline"], state["progress"]
    run.trace.window_start()
    before = len(progress.relaxed)
    batches, elapsed, last = 0, 0.0, 0.0
    t0 = time.perf_counter()
    while elapsed < run.seconds - last / 2:
        n = run.traffic["profile_batches"] if batches == 0 else 1
        t_batch = time.perf_counter()
        with run.trace.profiled():  # the first n batches of a traced run
            for _ in range(n):
                pipeline.iterate_once()
                sync(run.device)
                batches += 1
        now = time.perf_counter()
        last, elapsed = (now - t_batch) / n, now - t0
        run.times.setdefault("window_batch_s", []).append(now - t_batch)
        if progress.queue == 0 and elapsed < run.seconds - last / 2:
            raise RuntimeError(f"the survey ran out after {batches} batches of the window: more images needed")
    images = len(progress.relaxed) - before
    record = dict(run.trace.snapshot(), images=images, batches=batches, window_s=elapsed)
    answers = graph_answers(pipeline, state["truth"].paths)
    answers["relaxed"] = sorted(answers["k_of_id"][i] for i in progress.relaxed)
    answers["truth"] = state["truth"]
    answers["batches"] = run.traffic["warm_batches"] + batches
    return Window(values={"ingest_images_per_s": images / elapsed}, record=record, answers=answers,
                  attempted=len(answers["nodes"]), failed=0)
