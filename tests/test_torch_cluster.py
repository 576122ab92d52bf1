"""The AR kernel's cluster-size rule and the tensor-core B10's fragment layout, on the
CPU: the choices the wrappers make for the card, held on given occupancy tables, and
the planted faults of the cluster layout applying to the kernel's source."""

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


def test_ar_split_raises_without_a_card():
    from tacotron2_tpu_torch.probes import ar_split
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='torch finds none'):
            ar_split.main(['--steps', '1'])
