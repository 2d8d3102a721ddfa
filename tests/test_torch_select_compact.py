"""The compaction of the two-pass protocol and of the occluder cache
(``kernels/sparse.py``: ``select_compact_plain``, the plain twin of
csrc/two_pass.cu's compaction and finish, and ``scatter_back``) on the CPU
against the JAX package's ``_compact_select``, ``_gather_parked`` and
``_scatter_back`` (``kernels/sparse_pallas.py``), called directly; the
finishing rule on both branches; and the two-pass wrappers without a read
back to the host. The kernel itself runs on the card
(``tests/test_torch_cuda.py``).

Tolerances: none. Slots, count, rays and merged outputs are the JAX
package's bit for bit (where it takes the compacted branch; where the count
exceeds the cap it takes the other, and every slot is parked here), and the
wrappers' results the one-pass sweeps' bit for bit."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import sparse_pallas as sp
from pathtracerpython_tpu_torch.kernels import build, sparse
from pathtracerpython_tpu_torch.ops.sort import PARK_DIR, PARK_ORIGIN
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import field_rays

SMALL, BIG_BRANCH = 1, 10**6   # m_div: pass 2 always fits / never fits


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flags(n, share, m, seed):
    """Seeded flags: each lane with probability ``share``; a share of
    "m" or "m+1" flags exactly that many lanes, spread over the wavefront."""
    rs = np.random.default_rng(seed)
    if isinstance(share, str):
        count = m + (1 if share == "m+1" else 0)
        flags = np.zeros(n, dtype=bool)
        flags[rs.choice(n, size=count, replace=False)] = True
        return flags
    return rs.uniform(size=n) < share


def _rays(n, seed):
    rs = np.random.default_rng(seed + 100)
    o3 = rs.normal(size=(3, n)).astype(np.float32)
    d3 = rs.normal(size=(3, n)).astype(np.float32)
    maxd = rs.uniform(0.0, 9.0, size=n).astype(np.float32)
    return o3, d3, maxd


# (n, share, m): shares 0, 0.3, 0.8 and 1, a count of exactly m and of
# m + 1, one lane, a ragged n
CASES = [(1000, 0.0, 512), (1000, 0.3, 512), (1000, 0.8, 512),
         (1000, 1.0, 512), (1000, "m", 512), (1000, "m+1", 512),
         (1, 1.0, 512), (1, 0.0, 512), (777, 0.5, 256), (777, 0.5, 512)]


@pytest.mark.parametrize("n,share,m", CASES)
def test_compaction_matches_jax(n, share, m):
    """The count; the slots up to the count, the parked gather and the
    scatter-back of a float and an int output: the JAX package's bit for
    bit where its lax.cond takes the compacted branch (count <= m). Past
    the cap its branch sweeps the whole wavefront again, and its slots go
    unused: every slot is parked here (the sentinel N), so the merge leaves
    pass 1's outputs as they are."""
    flags = _flags(n, share, m, seed=n + m)
    o3, d3, maxd = _rays(n, seed=n)
    s = sparse.select_compact_plain(
        torch.from_numpy(flags), m, torch.from_numpy(o3),
        torch.from_numpy(d3), torch.from_numpy(maxd))
    jsel, jcnt = sp._compact_select(jnp.asarray(flags), m)
    cnt = int(jcnt)
    assert int(s.count[0]) == cnt == int(flags.sum())
    assert bool(s.taken[0]) == (cnt > m)
    rs = np.random.default_rng(7)
    t1 = rs.normal(size=n).astype(np.float32)
    t2 = rs.normal(size=m).astype(np.float32)
    i1 = rs.integers(-1, 10**6, size=n).astype(np.int32)
    i2 = rs.integers(-1, 10**6, size=m).astype(np.int32)
    merged = [sparse.scatter_back(torch.from_numpy(a), s.sel,
                                  torch.from_numpy(b))
              for a, b in ((t1, t2), (i1, i2))]
    if cnt <= m:
        np.testing.assert_array_equal(s.sel[:cnt].numpy(),
                                      np.asarray(jsel)[:cnt])
        o2, d2, valid = sp._gather_parked(jnp.asarray(o3), jnp.asarray(d3),
                                          jsel, jcnt)
        md2 = jnp.where(valid, jnp.take(jnp.asarray(maxd), jsel), 1.0)
        for got, want in zip(s.rays, (o2, d2, md2)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, (a, b) in zip(merged, ((t1, t2), (i1, i2))):
            want = sp._scatter_back(jnp.asarray(a), jsel, valid,
                                    jnp.asarray(b), n)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert (s.sel == n).all()
        np.testing.assert_array_equal(merged[0].numpy(), t1)
        np.testing.assert_array_equal(merged[1].numpy(), i1)


@pytest.mark.parametrize("share", [0.3, "m", "m+1", 1.0])
def test_finishing_rule(share):
    """Both branches of the finish: where the count fits, the slots past
    it are parked (PARK_ORIGIN, PARK_DIR, window 1) with the sentinel N,
    ``taken`` is False and the fallback's counts are all 0; where it does
    not, every slot is so parked, ``taken`` is True and the counts are the
    full lists'. Without ``ncand`` there are none; without ``maxd`` no
    windows."""
    n, m = 1000, 400
    flags = torch.from_numpy(_flags(n, share, m, seed=11))
    o3, d3, maxd = (torch.from_numpy(x) for x in _rays(n, seed=3))
    ncand = torch.from_numpy(np.random.default_rng(5).integers(
        1, 50, size=4).astype(np.int32))
    s = sparse.select_compact_plain(flags, m, o3, d3, maxd, ncand)
    cnt = int(flags.sum())
    taken = cnt > m
    assert bool(s.taken[0]) is taken
    assert torch.equal(s.ncand_fb, ncand if taken else torch.zeros_like(
        ncand))
    parked = torch.arange(m) >= (0 if taken else cnt)
    assert (s.sel[parked] == n).all() and (s.sel[~parked] < n).all()
    o2, d2, md2 = s.rays
    assert torch.equal(o2[:, parked], torch.tensor(PARK_ORIGIN)[:, None]
                       .expand(3, int(parked.sum())))
    assert torch.equal(d2[:, parked], torch.tensor(PARK_DIR)[:, None]
                       .expand(3, int(parked.sum())))
    assert (md2[parked] == 1.0).all()
    lanes = s.sel[~parked]
    assert torch.equal(lanes, torch.nonzero(flags).flatten()[
        :int((~parked).sum())])
    assert torch.equal(o2[:, ~parked], o3[:, lanes])
    assert torch.equal(md2[~parked], maxd[lanes])
    bare = sparse.select_compact_plain(flags, m, o3, d3)
    assert bare.ncand_fb is None and len(bare.rays) == 2
    assert all(torch.equal(a, b) for a, b in zip(bare.rays, s.rays[:2]))


def test_cpu_entries_run_the_plain_twins():
    """On the CPU the compact entry is ``select_compact_plain``, and the
    finality entries are ``two_pass_flags_plain`` then the same, with the
    flags and bound where asked; the scene's box is cached per scene and
    is ``scene_box`` of its cluster boxes."""
    scene = arrays.pack_scene(synthetic.box_field_scene(n_boxes=40),
                              tri_order="morton", device="cpu")
    o3, d3u = field_rays(1300, seed=4, parked=((100, 300),))
    flags = torch.from_numpy(_flags(1300, 0.4, 512, seed=1))
    maxd = torch.full((1300,), 5.0)
    a = sparse.select_compact(flags, 512, o3, d3u, maxd)
    b = sparse.select_compact_plain(flags, 512, o3, d3u, maxd)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    aabb8 = sparse.cluster_aabbs(sparse.pack_for_sparse(scene))
    box = sparse.scene_cluster_box(scene)
    assert sparse.scene_cluster_box(scene) is box
    assert torch.equal(box, sparse.scene_box(aabb8))
    lists = sparse.window_lists(aabb8, o3, d3u, maxd, sparse.R_BLK)
    head, drops = sparse.truncate_lists(lists, 2)
    occ = sparse.sparse_any_hit_plain(o3, d3u, maxd,
                                      sparse.pack_for_sparse(scene), aabb8,
                                      head, sparse.R_BLK)
    s = sparse.any_hit_select_compact(o3, d3u, maxd, occ, aabb8, box, drops,
                                      sparse.R_BLK, 512, lists.ncand,
                                      want_flags=True, want_ne=True)
    want = sparse.two_pass_flags_plain(o3, d3u, aabb8, drops, sparse.R_BLK,
                                       maxd, sparse.any_hit_open(occ, maxd))
    assert torch.equal(s.flags, want[0]) and torch.equal(s.ne, want[1])
    assert s.flags.any() and not s.flags.all()
    c = sparse.select_compact_plain(want[0], 512, o3, d3u, maxd, lists.ncand)
    for x, y in zip((s.sel, s.count, s.taken, *s.rays, s.ncand_fb),
                    (c.sel, c.count, c.taken, *c.rays, c.ncand_fb)):
        assert torch.equal(x, y)
    bare = sparse.any_hit_select_compact(o3, d3u, maxd, occ, aabb8, box,
                                         drops, sparse.R_BLK, 512)
    assert bare.flags is None and bare.ne is None and bare.ncand_fb is None


def test_park_constants_of_the_kernel():
    """The finish parks a slot where ops/sort.py parks a lane."""
    with open(os.path.join(build.CSRC_DIR, "two_pass.cu")) as f:
        text = f.read()
    value = lambda name: float(re.search(
        rf"constexpr float {name} = ([0-9.e+-]+)f;", text).group(1))
    assert PARK_ORIGIN == (0.0, value("kParkOriginY"), 0.0)
    assert PARK_DIR == (0.0, value("kParkDirY"), 0.0)
    assert sparse.SELECT_TILE == 256


@pytest.fixture(scope="module")
def field():
    """A 160-box field (16 clusters) and 1,500 random rays with a parked
    run; the one-pass nearest sweeps (both block sizes) and any-hit."""
    scene = arrays.pack_scene(synthetic.box_field_scene(n_boxes=160),
                              tri_order="morton", device="cpu")
    o3, d3u = field_rays(1500, seed=9, parked=((600, 800),))
    maxd = torch.where(o3[1] == PARK_ORIGIN[1], 0.0, 6.0)
    want = {r: sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, r_blk=r,
                                              two_pass=0)
            for r in (sparse.R_BLK, sparse.R_BLK_HYBRID_NEAREST)}
    return scene, o3, d3u, maxd, want, sparse.sparse_any_hit_cm(
        o3, d3u, maxd, scene, two_pass=0)


def _no_host_reads(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a read back to the host")

    monkeypatch.setattr(torch, "nonzero", refuse)
    for name in ("nonzero", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("m_div", [SMALL, BIG_BRANCH])
@pytest.mark.parametrize("r_blk", [sparse.R_BLK,
                                   sparse.R_BLK_HYBRID_NEAREST])
def test_two_pass_nearest_reads_nothing_back(field, monkeypatch, r_blk,
                                             m_div):
    """The two-pass nearest sweep calls no ``torch.nonzero``, ``.item()``
    or ``.tolist()`` in either branch, and gives the one-pass result bit
    for bit; the branch it took is the one ``m_div`` forces."""
    scene, o3, d3u, _, want, _ = field
    taken = []
    real = sparse.select_compact_plain
    monkeypatch.setattr(sparse, "select_compact_plain", lambda *a, **kw: (
        taken.append(real(*a, **kw)) or taken[-1]))
    with monkeypatch.context() as patch:
        _no_host_reads(patch)
        t, idx = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, r_blk=r_blk,
                                                two_pass=4, m_div=m_div)
    (s,) = taken
    assert bool(s.taken[0]) == (m_div == BIG_BRANCH)
    assert int(s.count[0]) > 0
    assert torch.equal(t, want[r_blk][0]) and torch.equal(idx,
                                                          want[r_blk][1])


@pytest.mark.parametrize("m_div", [SMALL, BIG_BRANCH])
def test_two_pass_any_hit_reads_nothing_back(field, monkeypatch, m_div):
    scene, o3, d3u, maxd, _, want = field
    taken = []
    real = sparse.select_compact_plain
    monkeypatch.setattr(sparse, "select_compact_plain", lambda *a, **kw: (
        taken.append(real(*a, **kw)) or taken[-1]))
    with monkeypatch.context() as patch:
        _no_host_reads(patch)
        occ = sparse.sparse_any_hit_cm(o3, d3u, maxd, scene, two_pass=4,
                                       m_div=m_div)
    (s,) = taken
    assert bool(s.taken[0]) == (m_div == BIG_BRANCH)
    assert torch.equal(occ, want) and want.any() and not want.all()


def test_cached_passes_compact_without_nonzero(field, monkeypatch):
    """The occluder cache's pass 2 takes its slots and rays from the
    compaction (no ``torch.nonzero``; its one host read is ``taken``) and
    its bits are the uncached sweep's on its relevant lanes, cold and warm,
    in both branches: every lane relevant (more open lanes than slots on
    this case) and 500 of them (all fit)."""
    scene, o3, d3u, maxd, _, want = field
    n = o3.shape[1]
    m = sparse.pass2_size(n)
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    monkeypatch.setattr(torch, "nonzero", lambda *a, **kw: 1 / 0)
    monkeypatch.setattr(torch.Tensor, "nonzero", lambda *a, **kw: 1 / 0)
    for relevant in (None, torch.arange(n) % 3 == 0):
        keep = torch.ones(n, dtype=torch.bool) if relevant is None \
            else relevant
        guess = torch.full((n,), -1, dtype=torch.int32)
        for _ in range(2):
            occ, guess = sparse.sparse_any_hit_cached_cm(
                o3, d3u, maxd, scene, guess, relevant=relevant)
            assert torch.equal(occ[keep], want[keep])
        first, second, sel = sparse.cached_passes(o3, d3u, maxd, tripack,
                                                  aabb8, None, guess,
                                                  relevant)
        open_lanes = int((~first.occ & keep).sum())
        assert (sel is None) == (open_lanes > m)
        if sel is not None:
            assert sel.shape == (m,) and int((sel < n).sum()) == open_lanes
            assert second.rays[0].shape == (3, m)
        assert (sel is None) == (relevant is None)
