"""The AR kernel's cluster-size rule and the tensor-core fragment layouts of B10 and B11,
on the CPU: the choices the wrappers make for the card, held on given occupancy tables,
the layouts written out and held to the mma's operands, and the planted faults of the
cluster layout applying to the kernel's source."""

import numpy as np
import pytest
import torch

import chip_smoke
from tacotron2_tpu_torch.config import default_hparams
from tacotron2_tpu_torch.ops import wavenet_ar

# clusters of N CTAs resident at once on a card like the H100 SXM (132 SMs in GPCs of 16
# or 18): 1 CTA an SM, clusters kept inside a GPC
H100_LIKE = {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}

# the four k rows of a B fragment of mma.sync.m16n8k16, after 16 kt + 2 (lane % 4)
FRAGMENT_ROWS = (0, 1, 8, 9)


def fragment_index(K: int, U: int):
    """(k, column) of each bf16 of the kernel's B fragments, shaped (U/8 blocks, K/16
    k-tiles, 4 gates, 32 lanes, 4): block j's fragment (kt, q, lane) holds rows 16 kt +
    2 (lane % 4) + FRAGMENT_ROWS of column q U + 8 j + lane / 4
    (`csrc/probes/matmul_probe.cu`, load_fragment)."""
    j = torch.arange(U // 8)[:, None, None, None, None]
    kt = torch.arange(K // 16)[None, :, None, None, None]
    q = torch.arange(4)[None, None, :, None, None]
    lane = torch.arange(32)[None, None, None, :, None]
    e = torch.tensor(FRAGMENT_ROWS)[None, None, None, None, :]
    k = 16 * kt + 2 * (lane % 4) + e
    col = q * U + 8 * j + lane // 4
    return torch.broadcast_tensors(k, col)


def pack_fragments(w):
    """w (K, 4U) in the layout each block of the kernel keeps in shared memory for the
    whole launch: (U/8, K/16, 4, 32, 4), the B fragments of its 32 columns."""
    k, col = fragment_index(w.shape[0], w.shape[1] // 4)
    return w[k, col]


def unpack_fragments(frags):
    """The inverse of `pack_fragments`: w (K, 4U) from its fragments."""
    blocks, kts = frags.shape[:2]
    K, U = 16 * kts, 8 * blocks
    k, col = fragment_index(K, U)
    w = torch.empty(K, 4 * U, dtype=frags.dtype, device=frags.device)
    w[k.reshape(-1), col.reshape(-1)] = frags.reshape(-1)
    return w


@pytest.mark.parametrize('B,want', [(1, 16), (2, 16), (8, 8), (20, 4), (66, 2), (132, 1)])
def test_cluster_size_takes_the_largest_cluster_that_holds_the_batch(B, want):
    assert wavenet_ar.cluster_size(B, H100_LIKE) == want


@pytest.mark.parametrize('B,want', [(1, 8), (2, 8), (16, 8), (17, 4), (200, 1)])
def test_cluster_size_without_clusters_of_16(B, want):
    """A table where 16 is not admitted (widths it does not split, or no shared memory
    for it); past every admitted size the batch runs one SM a sequence."""
    assert wavenet_ar.cluster_size(B, {**H100_LIKE, 16: 0}) == want


def test_cluster_size_when_nothing_is_resident():
    """Nothing admitted at all: N = 1 (a cluster of one need not be co-resident; the
    launch itself raises if the card refuses it)."""
    assert wavenet_ar.cluster_size(2, {n: 0 for n in wavenet_ar.CLUSTER_SIZES}) == 1


def test_a_cluster_outside_the_sizes_raises_before_dispatch():
    hp = default_hparams()
    hp.parse('layers=2,stacks=1,residual_channels=8,gate_channels=16,skip_out_channels=8')
    with pytest.raises(ValueError, match='cluster must be one of'):
        wavenet_ar.generate_ar({}, torch.zeros(1, 2, hp.cin_channels), torch.zeros(1, 2), hp,
                               cluster=3)


@pytest.mark.parametrize('K,U', [(64, 16), (128, 64), (1792, 32)])
def test_matmul_fragments_round_trip(K, U):
    """The B fragments each block keeps in shared memory hold every weight once:
    unpacking the packing gives w back, bit for bit."""
    w = torch.from_numpy(np.random.default_rng(K + U).normal(0, 0.01, (K, 4 * U))) \
        .to(torch.bfloat16)
    frags = pack_fragments(w)
    assert frags.shape == (U // 8, K // 16, 4, 32, 4)
    assert torch.equal(unpack_fragments(frags), w)


def test_matmul_fragments_are_mma_b_tiles():
    """Lane l's fragment of k-tile kt and gate q is what mma.sync.m16n8k16 takes as B
    (k x n = 16 x 8, column n = l / 4, rows 2 (l % 4) + {0, 1, 8, 9}) of the tile
    w[16 kt : 16 kt + 16, q U + 8 j : q U + 8 j + 8] of block j; the product of an
    A tile with the tile rebuilt from the fragments is the product with w's tile."""
    K, U = 64, 16
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(0, 1, (K, 4 * U))).float()
    frags = pack_fragments(w)
    a = torch.from_numpy(rng.normal(0, 1, (16, 16))).float()
    for j in range(U // 8):
        for kt in range(K // 16):
            for q in range(4):
                tile = torch.empty(16, 8)
                for lane in range(32):
                    for e, row in enumerate(FRAGMENT_ROWS):
                        tile[2 * (lane % 4) + row, lane // 4] = frags[j, kt, q, lane, e]
                want = w[16 * kt:16 * kt + 16, q * U + 8 * j:q * U + 8 * j + 8]
                assert torch.equal(tile, want)
                assert torch.allclose(a @ tile, a @ want)


@pytest.mark.parametrize('fault', list(chip_smoke.CLUSTER_MUTANTS))
def test_cluster_mutants_apply_to_the_source(fault):
    """Each planted fault of the cluster layout changes exactly one place of
    csrc/wavenet_ar.cu, and no other mutant's."""
    from tacotron2_tpu_torch.ops import _build
    import os
    with open(os.path.join(_build.CSRC_DIR, 'wavenet_ar.cu'), encoding='utf-8') as f:
        source = f.read()
    old, new = chip_smoke.CLUSTER_MUTANTS[fault]
    text = chip_smoke.mutated_source(fault)
    assert text != source and text.replace(new, old) == source
    assert fault not in chip_smoke.ALL_MUTANTS


def test_ar_split_slots_follow_the_kernel_source():
    """The timing probe's slot names are the kernel's ProfSlot enum, in its order, and
    each of its variants' macros is one the source reads."""
    import os
    import re
    from tacotron2_tpu_torch.ops import _build
    from tacotron2_tpu_torch.probes import ar_split
    with open(os.path.join(_build.CSRC_DIR, 'wavenet_ar.cu'), encoding='utf-8') as f:
        source = f.read()
    enum = re.search(r'enum ProfSlot \{([^}]*)\}', source).group(1)
    names = [n.strip() for n in enum.split(',') if n.strip()]
    assert names[-1] == 'P_SLOTS'
    assert [n[2:].lower() for n in names[:-1]] == list(ar_split.SLOTS)
    for macros in ar_split.VARIANTS.values():
        for m in macros:
            assert f'#ifdef {m.split("=")[0]}' in source or \
                f'#ifndef {m.split("=")[0]}' in source, m


def test_ar_split_configs_name_their_heads():
    """Each of the timing probe's configs at the defaults' widths runs the head and
    chain its name says, and the NLL runs only on a categorical head."""
    from tacotron2_tpu_torch.probes import ar_split
    heads = {}
    for name, extra in ar_split.CONFIGS.items():
        if extra is None:
            continue
        hp = default_hparams()
        if extra:
            hp.parse(extra)
        assert (hp.residual_channels, hp.gate_channels, hp.skip_out_channels) == (128, 256, 128)
        heads[name] = ('big' if wavenet_ar.is_big_vocab(hp) else 'categorical'
                       if wavenet_ar.is_categorical(hp) else 'mol' if wavenet_ar.is_mol(hp)
                       else 'gaussian', bool(hp.wavenet_fused_ar))
    assert heads == {'default': ('gaussian', True), 'plain': ('gaussian', False),
                     'mol': ('mol', True), 'categorical': ('categorical', True),
                     'categorical_nll': ('categorical', True), 'big': ('big', True)}
    assert all(heads[c][0] in ('categorical', 'big') for c in ar_split.NLL_CONFIGS)


def test_ar_split_raises_without_a_card():
    from tacotron2_tpu_torch.probes import ar_split
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='torch finds none'):
            ar_split.main(['--steps', '1'])


# ---------------------------------------------------------------- B11's fragments

B11_CL = 2  # CTAs a cluster of csrc/probes/microbench.cu (CL): the K-split


def b11_k_tiles(U: int, rank: int):
    """The global k-tiles of the B fragments of CTA `rank` of a cluster
    (`csrc/probes/microbench.cu`: kt1s, kt1c, kt2), in its local order: g1's streamed
    ones (zeros, then h1), g1's resident ctx ones, g2's (h1', then h2)."""
    zk, ck, hk = 16 // B11_CL, 32 // B11_CL, U // (16 * B11_CL)
    streamed = [zk * rank + i for i in range(zk)] + [48 + hk * rank + i for i in range(hk)]
    ctx = [16 + ck * rank + i for i in range(ck)]
    g2 = [hk * rank + i for i in range(hk)] + [U // 16 + hk * rank + i for i in range(hk)]
    return streamed, ctx, g2


def b11_staged_rows(U: int, rank: int):
    """The input row (of x0 = [zeros | ctx | h1], or of [h1' | h2]) that each column of
    CTA `rank`'s staged x holds, in each of its stagings (the kernel's `stage` calls),
    listed k-tile by k-tile as the products read them: x0's zero rows are not staged (their
    A fragments are zero registers), then the h1 part; the ctx part; the h1' part, then h2."""
    kq = U // B11_CL
    streamed = [None] * (256 // B11_CL) + [768 + kq * rank + j for j in range(kq)]
    ctx = [256 + 512 // B11_CL * rank + j for j in range(512 // B11_CL)]
    h1n = [kq * rank + j for j in range(kq)]
    h2 = [U + kq * rank + j for j in range(kq)]
    return streamed, ctx, h1n + h2


def b11_fragment_index(U: int, cluster: int, k_tiles):
    """(k, column) of each bf16 of cluster `cluster`'s B fragments over `k_tiles`, shaped
    (k-tiles, 4 CL tiles, 32 lanes, 4): tile n holds columns (n / CL) U + 8 CL cluster +
    8 (n % CL) + lane / 4 (gate n / CL, unit group n % CL), rows 16 kt + 2 (lane % 4) +
    FRAGMENT_ROWS (`fragment`; the index i of W2, W1C and w1s is (kt, n, lane) =
    (i / (128 CL), i / 32 % (4 CL), i % 32))."""
    kt = torch.tensor(k_tiles)[:, None, None, None]
    n = torch.arange(4 * B11_CL)[None, :, None, None]
    lane = torch.arange(32)[None, None, :, None]
    e = torch.tensor(FRAGMENT_ROWS)[None, None, None, :]
    k = 16 * kt + 2 * (lane % 4) + e
    col = (n // B11_CL) * U + 8 * B11_CL * cluster + 8 * (n % B11_CL) + lane // 4
    return torch.broadcast_tensors(k, col)


@pytest.mark.parametrize('U', [256, 1024])
def test_microbench_fragments_hold_each_weight_once(U):
    """Over the U/(8 CL) clusters, the fragments of g1 (streamed and resident) and of g2
    hold every weight exactly once: the K-split over ranks and the columns over clusters
    partition both matrices."""
    for which, rows in (('g1', 256 + 512 + U), ('g2', 2 * U)):
        seen = torch.zeros(rows, 4 * U, dtype=torch.int32)
        for c in range(U // (8 * B11_CL)):
            for r in range(B11_CL):
                streamed, ctx, g2 = b11_k_tiles(U, r)
                for kts in ((streamed, ctx) if which == 'g1' else (g2,)):
                    k, col = b11_fragment_index(U, c, kts)
                    seen.index_put_((k.reshape(-1), col.reshape(-1)),
                                    torch.ones(k.numel(), dtype=torch.int32), accumulate=True)
        assert torch.equal(seen, torch.ones_like(seen)), which


@pytest.mark.parametrize('U', [256, 1024])
def test_microbench_staged_x_lines_up_with_the_k_tiles(U):
    """Local k-tile i of each product multiplies the staged columns 16 i .. 16 i + 15,
    which hold the input rows of its fragments' k rows: A and B meet on the same k (the
    zero rows of x0, unstaged, are the first k-tiles of the streamed product and fall in
    x0's zero segment)."""
    for r in range(B11_CL):
        for kts, staged in zip(b11_k_tiles(U, r), b11_staged_rows(U, r)):
            for i, kt in enumerate(kts):
                rows = staged[16 * i:16 * i + 16]
                if rows[0] is None:
                    assert 16 * kt + 15 < 256 and all(x is None for x in rows)
                else:
                    assert rows == list(range(16 * kt, 16 * kt + 16))


def test_microbench_fragments_are_mma_b_tiles():
    """Lane l's fragment of local k-tile i and tile n is what mma.sync.m16n8k16 takes as B
    of the 16 x 8 tile of g2 at rows 16 kt, columns (n / CL) U + 8 CL c + 8 (n % CL); and
    the ranks' K-split products of a cluster add up to x @ g2 over its columns."""
    U, CL = 256, B11_CL
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(0, 1, (2 * U, 4 * U)))
    x = torch.from_numpy(rng.normal(0, 1, (32, 2 * U)))
    a = torch.from_numpy(rng.normal(0, 1, (16, 16)))
    c = 3
    cols = torch.tensor([(n // CL) * U + 8 * CL * c + 8 * (n % CL) + j
                         for n in range(4 * CL) for j in range(8)])
    total = torch.zeros(32, 32 * CL, dtype=torch.float64)
    for r in range(CL):
        kts = b11_k_tiles(U, r)[2]
        k, col = b11_fragment_index(U, c, kts)
        frags = w[k, col]
        for i, kt in enumerate(kts):
            for n in range(4 * CL):
                tile = torch.empty(16, 8, dtype=torch.float64)
                for lane in range(32):
                    for e, row in enumerate(FRAGMENT_ROWS):
                        tile[2 * (lane % 4) + row, lane // 4] = frags[i, n, lane, e]
                c0 = (n // CL) * U + 8 * CL * c + 8 * (n % CL)
                want = w[16 * kt:16 * kt + 16, c0:c0 + 8]
                assert torch.equal(tile, want)
                assert torch.allclose(a @ tile, a @ want)
        rows = torch.tensor([16 * kt + j for kt in kts for j in range(16)])
        total += x[:, rows] @ w[rows][:, cols]
    assert torch.allclose(total, x @ w[:, cols])


# ---------------------------------------------------------------- C4: two sequences a cluster

H100_PAIRS = {**H100_LIKE, wavenet_ar.PAIRS: 66}


@pytest.mark.parametrize('B,fused,want', [
    (1, True, (16, 1)), (2, True, (16, 1)), (66, True, (2, 1)), (67, True, (2, 2)),
    (98, True, (2, 2)), (131, True, (2, 2)), (132, True, (2, 2)), (264, True, (1, 1)),
    (1, False, (16, 1)), (2, False, (16, 1)), (66, False, (2, 1)), (67, False, (1, 1)),
    (98, False, (1, 1)), (131, False, (1, 1)), (132, False, (1, 1)), (264, False, (1, 1))])
def test_cluster_layout_pairs_sequences_where_one_sm_a_sequence_would_run(B, fused, want):
    """(N, P): two sequences on each cluster of 2 where cluster_size gives 1 on the fused
    chain, if the card keeps ceil(B/2) such clusters resident; else P = 1."""
    assert wavenet_ar.cluster_layout(B, H100_PAIRS, fused) == want


@pytest.mark.parametrize('B', [67, 132])
def test_cluster_layout_without_pairs_resident(B):
    """No cluster of 2 running two sequences resident (or the kernel admits none): one
    SM a sequence, as before."""
    assert wavenet_ar.cluster_layout(B, {**H100_LIKE, wavenet_ar.PAIRS: 0}, True) == (1, 1)
    assert wavenet_ar.cluster_layout(B, {**H100_PAIRS, 2: 0}, True) == (2, 2)


def test_pairs_are_chosen_on_the_fused_chain_of_the_small_layout():
    """Two sequences a cluster are the automatic choice only where they were measured
    faster: the fused chain, and only where the kernel admits them (its SMALL layout, the
    defaults' widths with any head but the big one), which the occupancy table says:
    PAIRS is 0 there off SMALL."""
    for B in (67, 132):
        assert wavenet_ar.cluster_layout(B, H100_PAIRS, True) == (2, 2)
        assert wavenet_ar.cluster_layout(B, H100_PAIRS, False) == (1, 1)
        off_small = {**H100_PAIRS, wavenet_ar.PAIRS: 0}
        assert wavenet_ar.cluster_layout(B, off_small, True) == (1, 1)


def _owners(B: int, N: int, P: int, R=128, G=256, S=128):
    """A numpy model of csrc/wavenet_ar.cu's ownership: for each CTA of the grid (cluster
    `blockIdx.x / N`, rank `blockIdx.x % N`), its first sequence b = cluster P, the
    sequences present np = min(P, B - b), and the (sequence, kind, column) it writes:
    gate pairs [rank G/(2N), ...), residual [rank R/N, ...), skip [rank S/N, ...).
    Returns (writes by (sequence, column), the clusters' absent sequences)."""
    hN, RN, SN = G // 2 // N, R // N, S // N
    writes = np.zeros((B, G // 2 + R + S), dtype=np.int64)
    absent = 0
    for cta in range(-(-B // P) * N):
        cl, rank = cta // N, cta % N
        b = cl * P
        n_present = min(P, B - b)
        absent += (P - n_present) if rank == 0 else 0
        for e in range(n_present):
            writes[b + e, rank * hN:(rank + 1) * hN] += 1
            writes[b + e, G // 2 + rank * RN:G // 2 + (rank + 1) * RN] += 1
            writes[b + e, G // 2 + R + rank * SN:G // 2 + R + (rank + 1) * SN] += 1
    return writes, absent


@pytest.mark.parametrize('B', [1, 2, 131, 132])
def test_two_sequences_a_cluster_own_each_column_once(B):
    """At P = 2 on clusters of 2 every (sequence, column) is written by exactly one CTA, as
    at P = 1 on a cluster of one; the odd last cluster's absent sequence writes nothing."""
    for N, P in ((2, 2), (1, 1), (2, 1)):
        writes, absent = _owners(B, N, P)
        assert (writes == 1).all(), (N, P)
        assert absent == (-B % 2 if P == 2 else 0)


def _job_item(w, acts, ks, KS, nq):
    """A numpy model of job_item: the partial sums of one column group and slice ks for nq
    sequences from each weight row loaded, f32, rows ks, ks + KS, ... in order."""
    acc = np.zeros((nq, w.shape[1]), np.float32)
    for r in range(ks, w.shape[0], KS):
        for e in range(nq):
            acc[e] = np.float32(acc[e] + np.float32(acts[e, r]) * w[r])
    return acc


def test_each_sequence_sums_its_k_slices_as_one_sequence_alone():
    """Two sequences from each load give each sequence the same f32 partial sums, slice by
    slice, as the sequence run alone (the outputs' bit-identity at P = 2)."""
    rng = np.random.default_rng(9)
    w = rng.normal(0, 1, (384, 8)).astype(np.float32)
    acts = rng.normal(0, 1, (2, 384)).astype(np.float32)
    for ks in (0, 5, 31):
        two = _job_item(w, acts, ks, 32, 2)
        for e in range(2):
            assert np.array_equal(two[e], _job_item(w, acts[e:e + 1], ks, 32, 1)[0])


# ---------------------------------------------------------------- B9's fragments

def test_critpath_tiles_are_mma_a_fragments():
    """Element e of lane l of a packed A tile is A[m][k] = w[16 kt + k][owned column m] at
    the row and column mma.sync.m16n8k16 gives register e of lane l (rows l/4, l/4 + 8;
    columns 2 (l % 4) + {0, 1, 8, 9}); the product of the tile rebuilt from the lanes
    with a B tile is w's tile's transpose times it."""
    from tacotron2_tpu_torch.probes import ar_critpath as m

    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(0, 1, (64, 256))).float()
    x = torch.from_numpy(rng.normal(0, 1, (64, 8))).float()
    for r in (0, 5, 15):
        tiles = m.a_tiles(w, slice(None), r, 128)
        cols = m.owned_columns(r, 128)
        assert tiles.shape == (4, 32, 8)
        total = torch.zeros(16, 8)
        for kt in range(4):
            a = torch.empty(16, 16)
            for lane in range(32):
                for e in range(8):
                    a[lane // 4 + m.A_ROW[e], 2 * (lane % 4) + m.A_COL[e]] = tiles[kt, lane, e]
            assert torch.equal(a, w[16 * kt:16 * kt + 16][:, cols].T)
            total += a @ x[16 * kt:16 * kt + 16]
        assert torch.allclose(total, w[:, cols].T @ x, atol=1e-4)


@pytest.mark.parametrize('variant', ['base', 'fused'])
def test_critpath_blocks_follow_the_schedule(variant):
    """Each phase's block in the packed stream starts where the one before ends, holds the
    gate, residual and past-tap tiles its record names, in that order, and fits a slot;
    every CTA's 16 columns of every matrix are packed, each column by one CTA."""
    from tacotron2_tpu_torch.probes import ar_critpath as m

    inp = m.make_inputs(L=4, B=2)
    tiles, table, slot_tiles = m.pack(variant, inp)
    recs = [dict(zip(m.RECORD, row)) for row in table.tolist()]
    assert len(recs) == (5 if variant == 'fused' else 8)
    off = 0
    for rec in recs:
        gate = rec['gate_z_tiles'] + rec['gate_h_tiles'] if rec['gate_layer'] >= 0 else 0
        want = gate + (8 if rec['os_layer'] >= 0 else 0) \
            + (16 if rec['consts_layer'] >= 0 else 0)
        assert (rec['tile_off'], rec['tile_count']) == (off, want)
        off += want
    assert tiles.shape == (16, off, 32, 8) and slot_tiles == max(r['tile_count'] for r in recs)
    cols = torch.cat([m.owned_columns(r, 128) for r in range(16)])
    assert torch.equal(cols.sort().values, torch.arange(256))
