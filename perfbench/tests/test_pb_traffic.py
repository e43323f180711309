"""The traffic generator: the same seed gives the same requests; fresh
keys never repeat; a re-edit session misses the caches once; batch
sources do not straddle chunks; every seed gives the same frame sizes in
another order; training rows all differ."""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from perfbench.harness import traffic as T

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME = {"height": 120, "width": 400}


def mix(name, **kw):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as fh:
        m = json.load(fh)
    m.update(pool_frames=6, **kw)
    return m


def take(seed, m, n):
    pool = T.frame_pool(seed, m, FRAME)
    return pool, list(itertools.islice(T.edit_requests(seed, m, pool), n))


def summary(reqs):
    return [(r["cache_key"], r["cars"], json.dumps(r["operations"]))
            for r in reqs]


@pytest.mark.parametrize("seed", [0, 2**31 + 11, -5, 3 * 2**64 + 1])
def test_same_seed_same_requests(seed):
    a, b = take(seed, mix("fresh"), 20)[1], take(seed, mix("fresh"), 20)[1]
    assert summary(a) == summary(b)
    assert all(np.array_equal(x["image_rgb"], y["image_rgb"])
               for x, y in zip(a, b))


def test_other_seed_other_requests():
    a, b = take(1, mix("fresh"), 10)[1], take(2, mix("fresh"), 10)[1]
    assert summary(a) != summary(b)


def test_same_sizes_every_seed():
    m = mix("fresh")
    sizes = [sorted(f["n"] for f in T.frame_pool(s, m, FRAME))
             for s in (1, 2, 3)]
    assert sizes[0] == sizes[1] == sizes[2]
    assert min(sizes[0]) == 5 and max(sizes[0]) <= 16


def test_fresh_keys_never_repeat():
    reqs = take(7, mix("fresh"), 50)[1]
    keys = [r["cache_key"] for r in reqs]
    assert len(set(keys)) == len(keys)
    assert all(r["first"] for r in reqs)


def test_reedit_misses_once_a_session():
    reqs = take(7, mix("reedit"), 120)[1]
    keys = [r["cache_key"] for r in reqs]
    assert len(set(keys)) == 3
    assert sum(r["first"] for r in reqs) == 3
    for k in set(keys):
        first = keys.index(k)
        assert keys[first:first + 40] == [k] * 40
        assert reqs[first]["first"]
    ops = [json.dumps(r["operations"]) for r in reqs[:40]]
    assert len(set(ops)) == 40


def test_batch_sources_do_not_straddle_chunks():
    m = mix("batch")
    reqs = take(7, m, 40)[1]
    bp = m["batch_pairs"]
    chunks = [reqs[i:i + bp] for i in range(0, len(reqs), bp)]
    seen = set()
    for c in chunks:
        keys = {r["cache_key"] for r in c}
        assert not keys & seen
        seen |= keys
        assert all(sum(r["cache_key"] == k for r in c) == m["session_len"]
                   for k in keys)


def test_operations_name_cars_of_the_frame():
    pool, reqs = take(9, mix("fresh", ops={"modify": 1, "zoom": [0.8, 1.5],
                                           "ry": [-3.0, 3.0],
                                           "move_px": 100,
                                           "p_delete": 1.0}), 10)
    for r in reqs:
        rois = r["dets"][2]
        centers = {((x1 + x2) / 2, (y1 + y2) / 2)
                   for y1, x1, y2, x2 in rois}
        kinds = [op["type"] for op in r["operations"]]
        assert kinds == ["modify", "delete"]
        for op in r["operations"]:
            assert (float(op["from"]["u"]), float(op["from"]["v"])) \
                in centers
        z = float(r["operations"][0]["zoom"])
        assert 0.8 <= z <= 1.5


@pytest.mark.parametrize("name", ["fresh", "reedit", "batch"])
def test_operations_follow_the_edit_benchmark(name):
    # 393 modify and 31 delete operations over the 92 edit pairs of the
    # 3D-SDN VKITTI edit benchmark, each on a car of its own
    m = mix(name)
    assert m["ops"]["modify"] == 393 / 92
    assert m["ops"]["p_delete"] == 31 / 92
    reqs = take(13, m, 2000)[1]
    mods = [sum(op["type"] == "modify" for op in r["operations"])
            for r in reqs]
    dels = [sum(op["type"] == "delete" for op in r["operations"])
            for r in reqs]
    assert abs(np.mean(mods) - 393 / 92) < 0.1
    assert abs(np.mean(dels) - 31 / 92) < 0.04
    assert set(dels) <= {0, 1} and min(mods) >= 1
    for r in reqs:
        named = [(op["from"]["u"], op["from"]["v"]) for op in r["operations"]]
        assert len(set(named)) == len(named) <= r["cars"]


def test_meshes_have_the_configured_faces(tmp_path):
    v, f = T.car_mesh(0, 0, 100, 200)
    assert f.shape == (39_600, 3)
    T.write_meshes(str(tmp_path), 0, {"count": 8, "n_theta": 4,
                                      "n_phi": 6})
    objs = list(tmp_path.rglob("model_normalized.obj"))
    assert len(objs) == 8


def test_training_rows_all_differ():
    batches = T.train_batches(5, {"pool_batches": 3}, {
        "batch_size": 4, "image_size": 8, "render_size": 8}, "cpu")
    rows = torch.cat([b["roi_norms"] for b in batches])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    again = T.train_batches(5, {"pool_batches": 3}, {
        "batch_size": 4, "image_size": 8, "render_size": 8}, "cpu")
    assert all(torch.equal(a["images"], b["images"])
               for a, b in zip(batches, again))
