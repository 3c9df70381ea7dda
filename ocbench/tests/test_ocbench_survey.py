"""The frozen renderer's truth: footprint, overlaps, serpentine order, the
block a seed picks, geotags, the JPEG encoder's bytes, and the same survey
for every seed of the ingest cell."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ocbench import survey as S
from ocbench.cell import load_json


@pytest.fixture(params=["nadir1600", "fixed1600"])
def spec(request):
    return S.SurveySpec.from_config(load_json("configs", request.param + ".json"))


def test_footprint_and_overlaps_match_the_config(spec):
    gsd = spec.altitude_m / spec.focal_px
    across, along = spec.width * gsd, spec.height * gsd  # image x across track, y along
    assert (across, along) == pytest.approx((48.0, 36.0))
    assert gsd == pytest.approx(0.03)
    assert 1 - spec.along_track_m / along == pytest.approx(0.75)
    assert 1 - spec.across_track_m / across == pytest.approx(0.6, abs=0.01)


def test_serpentine_order(spec):
    plain = dataclasses.replace(spec, position_jitter_m=0.0)
    pos, quats, index = S.flight_plan(plain, seed=7)
    # the jitter moves each trigger position within its bound east and
    # north, and nothing else
    moved, moved_quats, moved_index = S.flight_plan(spec, seed=7)
    assert np.array_equal(moved_quats, quats) and np.array_equal(moved_index, index)
    assert np.abs(moved[:, :2] - pos[:, :2]).max() <= spec.position_jitter_m
    assert np.array_equal(moved[:, 2], pos[:, 2])
    assert len(pos) == spec.lines * spec.per_line
    for line in range(spec.lines):
        mine = np.where(index[:, 0] == line)[0]
        assert np.all(np.diff(mine) == 1)  # a line is flown in one go
        ys = pos[mine, 1]
        step = np.diff(ys)
        assert np.allclose(step, spec.along_track_m if line % 2 == 0 else -spec.along_track_m)
        assert np.allclose(pos[mine, 0], pos[mine[0], 0])
    # the next line starts where the last one ended, one spacing across
    ends = [np.where(index[:, 0] == line)[0] for line in range(2)]
    assert pos[ends[1][0], 1] == pos[ends[0][-1], 1]
    assert pos[ends[1][0], 0] - pos[ends[0][0], 0] == pytest.approx(spec.across_track_m)
    assert np.allclose(pos[:, 2], spec.altitude_m)
    assert np.allclose(np.linalg.norm(quats, axis=1), 1.0)


def test_block_is_drawn_from_the_seed_and_keeps_the_flight_order(spec):
    lines, per_line = S.pick_block(spec, 2**31 + 99, 3, 4)
    assert (len(lines), len(per_line)) == (3, 4)
    assert S.pick_block(spec, 2**31 + 99, 3, 4) == (lines, per_line)
    whole = S.flight_plan(spec, 5)
    block = S.flight_plan(spec, 5, lines, per_line)
    rows = [int(np.where((whole[2] == ij).all(1))[0][0]) for ij in block[2]]
    assert rows == sorted(rows)
    assert np.array_equal(whole[0][rows], block[0]) and np.array_equal(whole[1][rows], block[1])


@pytest.mark.parametrize("origin", [None, -60.0, 60.0])
def test_written_survey_and_geotags(tmp_path, origin):
    spec = S.SurveySpec(width=160, height=120, focal_px=200.0, altitude_m=60.0, along_track_m=9.0,
                        across_track_m=19.0, lines=2, per_line=3, texture_px_per_150m=256, jpeg_quality=90,
                        relief_amplitude_m=8.0, focal_tag_scale=1.05, gain_spread=0.1)
    kw = {} if origin is None else dict(origin_latlon=S.draw_origin(2**31 + 9, abs(origin)))
    sv = S.write_survey(str(tmp_path), spec, 2**31 + 7, device="cpu", **kw)
    assert [os.path.basename(p) for p in sv.paths] == [f"IMG_{k:04d}.jpg" for k in range(6)]
    assert np.all((sv.gains >= 0.9) & (sv.gains <= 1.1))
    from opencalibration_tpu_torch.geo.geo_coord import GeoCoord
    from opencalibration_tpu_torch.io.jpeg import decode_jpeg

    geo = GeoCoord()
    for k, path in enumerate(sv.paths):
        with open(path[:-4] + ".json") as f:
            tag = json.load(f)
        if k == 0:
            assert (tag["latitude"], tag["longitude"]) == pytest.approx(kw.get("origin_latlon", (47.4, 8.5)))
            geo.set_origin(tag["latitude"], tag["longitude"])
        assert tag["focal_length_px"] == pytest.approx(210.0)
        local = geo.to_local(tag["latitude"], tag["longitude"], tag["altitude"])
        assert np.abs(local - sv.local_positions()[k]).max() < 1e-6
        with open(path, "rb") as f:
            assert decode_jpeg(f.read()).shape == (120, 160, 3)


def test_renderer_matches_the_programs_renderer_it_was_copied_from():
    from opencalibration_tpu_torch.testing import survey as T

    spec = S.SurveySpec(width=96, height=64, focal_px=120.0, altitude_m=60.0, along_track_m=9.0,
                        across_track_m=19.0, lines=2, per_line=2, texture_px_per_150m=256, jpeg_quality=90,
                        relief_amplitude_m=8.0)
    pos, quats, _ = S.flight_plan(spec, 3)
    tex = S.make_texture(3, 256, "cpu")
    ours = S.render_views(tex, pos, quats, spec, 150.0)
    theirs = T.render_views(tex.numpy(), pos, quats, width=96, height=64, focal=120.0, ground_extent=150.0,
                            relief_amplitude=8.0, device="cpu")
    assert torch.allclose(ours, T.colorize(theirs[..., 0], theirs[..., 1:]), atol=1e-4)


def test_jpeg_encoder_equals_the_programs_byte_for_byte():
    from ocbench.jpeg import encode_jpeg
    from opencalibration_tpu_torch.io.jpeg import encode_jpeg as program_encode

    rng = np.random.default_rng(0)
    for shape, q in (((48, 64, 3), 95), ((33, 17), 80), ((40, 56, 3), 50)):
        img = (rng.random(shape) * 255).astype(np.uint8)
        assert encode_jpeg(img, q) == program_encode(img, q)


def test_drawn_origin():
    """The first geotag is drawn from the seed within the latitude given,
    the same for the same seed."""
    seeds = [2**31 + k for k in range(50)]
    drawn = [S.draw_origin(seed, 60.0) for seed in seeds]
    assert drawn == [S.draw_origin(seed, 60.0) for seed in seeds]
    lat, lon = np.array(drawn).T
    assert np.all(np.abs(lat) <= 60.0) and np.all(np.abs(lon) <= 180.0)
    assert lat.min() < -30.0 and lat.max() > 30.0 and len(set(drawn)) == len(seeds)


def small_ingest_spec() -> S.SurveySpec:
    config = load_json("configs", "nadir1600.json")
    config["survey"].update(width=320, height=240, focal_px=400.0, texture_px_per_150m=512, lines=3, per_line=4)
    return S.SurveySpec.from_config(config)


def test_ingest_seeds_render_the_same_pixels_and_move_only_the_geotags(tmp_path, monkeypatch):
    """Two seeds of the ingest cell, at the CPU run's small size, write the
    same JPEG bytes, so the same pixels, and the same truth; their sidecars
    differ only in latitude and longitude."""
    from ocbench.cell import Run
    from ocbench.modes import ingest
    from ocbench.trace import Trace
    from opencalibration_tpu_torch.io.jpeg import decode_jpeg

    monkeypatch.setattr(ingest, "SURVEY_CACHE", str(tmp_path / "cache"))
    config = load_json("configs", "nadir1600.json")
    config["survey"] = dataclasses.asdict(small_ingest_spec())
    traffic = load_json("traffic", "ingest.json")
    written = []
    for seed in (2**31 + 11, 2**31 + 12):
        run = Run({"name": "ingest.nadir1600"}, config, traffic, seed, 0.0, "cpu", str(tmp_path), Trace(False))
        (tmp_path / str(seed)).mkdir()
        written.append(ingest.render(run, str(tmp_path / str(seed))))
    a, b = written
    assert [os.path.basename(p) for p in a.paths] == [os.path.basename(p) for p in b.paths]
    assert np.array_equal(a.positions, b.positions) and np.array_equal(a.quats, b.quats)
    for pa, pb in zip(a.paths, b.paths):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            bytes_a, bytes_b = fa.read(), fb.read()
        assert bytes_a == bytes_b
        assert np.array_equal(decode_jpeg(bytes_a), decode_jpeg(bytes_b))
        with open(pa[:-4] + ".json") as fa, open(pb[:-4] + ".json") as fb:
            tag_a, tag_b = json.load(fa), json.load(fb)
        assert {k for k in tag_a if tag_a[k] != tag_b[k]} == {"latitude", "longitude"}


def test_cached_survey_is_the_written_survey_and_renders_once(tmp_path, monkeypatch):
    """The cache's JPEGs and the sidecars beside them are what
    ``write_survey`` writes, byte for byte; a second call renders nothing."""
    spec = small_ingest_spec()
    origin = S.draw_origin(2**31 + 31, 60.0)
    for name in ("plain", "first", "second"):
        (tmp_path / name).mkdir()
    plain = S.write_survey(str(tmp_path / "plain"), spec, 5, device="cpu", origin_latlon=origin)
    first = S.cached_survey(str(tmp_path / "first"), spec, 5, str(tmp_path / "cache"), device="cpu",
                            origin_latlon=origin)

    def no_render(*args, **kw):
        raise AssertionError("rendered again")

    monkeypatch.setattr(S, "_render_jpegs", no_render)
    second = S.cached_survey(str(tmp_path / "second"), spec, 5, str(tmp_path / "cache"), device="cpu",
                             origin_latlon=origin)
    assert len(os.listdir(tmp_path / "cache")) == 1
    for sv in (first, second):
        assert np.array_equal(sv.positions, plain.positions) and np.array_equal(sv.gains, plain.gains)
        for p, q in zip(plain.paths, sv.paths):
            assert os.path.basename(p) == os.path.basename(q)
            for a, b in ((p, q), (p[:-4] + ".json", q[:-4] + ".json")):
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read()


def test_ingest_seeds_give_the_link_the_same_candidates():
    """The geotags of three seeds, turned into local positions as the program
    turns them, give the link stage the same candidate pairs batch by batch:
    the survey's jitter leaves no tie among a camera's nearest images for
    the geotags' rounding to break."""
    from opencalibration_tpu_torch.geo.geo_coord import GeoCoord
    from opencalibration_tpu_torch.pipeline.stages import LinkStage
    from opencalibration_tpu_torch.types.graph import MeasurementGraph

    config = load_json("configs", "nadir1600.json")
    spec = S.SurveySpec.from_config(config)
    traffic = load_json("traffic", "ingest.json")
    batch = config["pipeline"]["batch_size"]
    pos, _, _ = S.flight_plan(spec, traffic["survey_seed"])
    local = pos - np.array([pos[0, 0], pos[0, 1], 0.0])
    picked = []
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        tags = S.TransverseMercator(*S.draw_origin(seed, traffic["max_latitude"])).to_wgs84(local)
        geo = GeoCoord()
        geo.set_origin(tags[0, 0], tags[0, 1])
        gps = {}
        stage, candidates = LinkStage(device="cpu"), []
        for b0 in range(0, len(local), batch):
            ids = range(b0, min(b0 + batch, len(local)))
            gps.update({k: np.asarray(geo.to_local(*tags[k]))[:2] for k in ids})
            stage.init(MeasurementGraph(seed=0), gps, list(ids))
            candidates.append(sorted(stage._candidates))
        picked.append(candidates)
    assert picked[0] == picked[1] == picked[2]
