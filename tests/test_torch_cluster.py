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
