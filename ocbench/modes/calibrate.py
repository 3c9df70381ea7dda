"""Calibrate: a field team's block, from its images to calibrated cameras.

Set-up renders a block of ``block_lines`` x ``block_per_line`` images of the
configuration's survey and runs one whole job to warm up. The survey and the
block's place are drawn from the traffic's ``survey_seed``, the same in
every run: any change to the images, or to the order they are handed over
in, changes the program's LM work by up to twice, so a block drawn from
``--seed`` would make the seed, not the program, decide the time. ``--seed``
draws where on the globe the survey lies (its first geotag, latitude within
``max_latitude``), which the program turns into the same local frame.

A job is a fresh pipeline made as the runner makes it on the block's files,
iterated from INITIAL_PROCESSING to the end of FINAL_GLOBAL_RELAX. The
window runs jobs back to back and stops at the first iterate boundary after
``--seconds``; the job still running then is dropped. ``calibrate_s`` is the
completed jobs' seconds over their count. The traced run profiles the
window's first job; its per-job metrics count the completed jobs only. Each
job's host clocks (``cell.host_clocks``) go to the run's wall seconds on
standard error.
"""

from __future__ import annotations

import os
import time

from ocbench import survey as S
from ocbench.cell import Window, host_clocks, make_pipeline, sync
from ocbench.modes.common import graph_answers


def setup(run):
    spec = S.SurveySpec.from_config(run.config)
    t = run.traffic
    survey_seed = t["survey_seed"]
    lines, per_line = S.pick_block(spec, survey_seed, t["block_lines"], t["block_per_line"])
    images = os.path.join(run.workdir, "survey")
    os.makedirs(images)
    with run.phase("render_s"):
        truth = S.write_survey(images, spec, survey_seed, device=run.device, lines=lines, per_line=per_line,
                               origin_latlon=S.draw_origin(run.seed, t["max_latitude"]))
    with run.phase("warm_jobs_s"):
        for _ in range(t["warm_jobs"]):
            _job(run, images, deadline=None)
    return dict(truth=truth, images=images)


def _job(run, images, deadline):
    """One job; None if ``deadline`` (perf_counter) passed before its end."""
    from opencalibration_tpu_torch.pipeline.pipeline import PipelineState

    pipeline = make_pipeline(run.config, images, run.device)
    while pipeline.get_state() != PipelineState.GENERATE_THUMBNAIL:
        pipeline.iterate_once()
        sync(run.device)
        if deadline is not None and time.perf_counter() >= deadline:
            return None
    return pipeline


def window(run, state) -> Window:
    run.trace.window_start()
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    jobs, clocks, answers, record = [], [], [], {}
    while time.perf_counter() < deadline:
        start, before = time.perf_counter(), host_clocks()
        with run.trace.profiled():  # the first job of a traced run
            pipeline = _job(run, state["images"], deadline)
        if pipeline is None:
            break
        jobs.append(time.perf_counter() - start)
        clocks.append({k: v - before[k] for k, v in host_clocks().items()})
        answers.append(graph_answers(pipeline, state["truth"].paths))
        record = run.trace.snapshot()  # as of the last completed job
        del pipeline
    if not jobs:
        raise RuntimeError(f"no job completed within the window of {run.seconds} s")
    record = dict(record, jobs=len(jobs), job_s=jobs)
    run.times["window_job_s"] = jobs
    run.times["window_job_host"] = clocks
    return Window(values={"calibrate_s": sum(jobs) / len(jobs)}, record=record,
                  answers=dict(jobs=answers, truth=state["truth"]), attempted=len(jobs), failed=0)
