"""The reduce-scatter exchange of the flash cluster kernels, emulated on
the CPU.

Four kernels add the blocks' float partial scores as a reduce-scatter
(``reduce_scatter_partials`` in csrc/flash_attention.cu): the 16-bit
cluster forward (head dims 640-4096, three to sixteen blocks) and the
float32 forward, dq and dk/dv at ``<SPLIT3_ANY>`` (640-2048, five to
sixteen). A warpgroup's 32 floats a thread are 1,024 float4 groups (float4
i of thread t is group 128 i + t), cut into one contiguous slice a block
(``flash_attention.exchange_slices``, the kernel's ``xchg_slice0``); each
block adds its slice's groups from every block's slot in rank order,
((p0 + p1) + p2) + .., and writes the sums in place into its own slot;
each thread then reads its 8 groups back from their owners
(``exchange_owner``, ``xchg_owner``). Held here, for every cluster size
from 3 to 16 (the range of the kernel's constexpr cover check), with
float32 partials from a numpy seed:

* every group lies in exactly one block's slice, the slices' sizes differ
  by at most one group, and each group's owner is the block whose slice
  holds it;
* the sums that the threads read back equal, bit for bit, the sums that
  every block forms when it reads all the slots and adds them in rank
  order (``add_cluster_partials_n``, the exchange it replaces), with the
  blocks' in-place writes emulated one block after another;
* a reduce-scatter that added another order (each block its own partial
  first) would not: the comparison sees the order;
* dq and dk/dv exchange two parts in one round, a thread's 16 floats of s
  in its groups 0-3 and 16 of dp in groups 4-7 (``keep_partial`` on each
  part in turn): each part comes back, bit for bit, as the rank-order sum
  of that part alone, at every cluster size they run (5 to 16), and not
  from the other part's groups.
"""

import numpy as np
import pytest

from gnn_rag_tpu_torch.llm import flash_attention as fa

WG = 128                      # threads of a warpgroup
N4 = fa.EXCHANGE_GROUPS // WG  # float4 groups a thread (32 floats)
SIZES = range(3, 17)          # the cluster sizes of the cover check
SPLIT3_SIZES = range(5, 17)   # the float32 <SPLIT3_ANY> clusters


def partials(nb, seed):
    """nb blocks' partial scores, [block, thread, 32 floats]: products of
    a few hundred terms' sizes, of either sign, some exactly 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb, WG, 4 * N4)) * 2.0 ** rng.integers(
        -8, 9, (nb, WG, 4 * N4))
    x[:, :, 5] = 0.0
    return x.astype(np.float32)


def slots(x):
    """Each block's slot: float4 i of thread t at group 128 i + t
    (``keep_partial``), [block, group, 4]."""
    nb = x.shape[0]
    return np.ascontiguousarray(
        x.reshape(nb, WG, N4, 4).transpose(0, 2, 1, 3)).reshape(
            nb, fa.EXCHANGE_GROUPS, 4)


def rank_order(parts):
    """((p0 + p1) + p2) + .. in float32, over the first axis."""
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s


def reduce_scatter(x, own_first=False):
    """The sums each thread holds after the reduce-scatter, [block,
    thread, 32 floats]: each block, one after another, sums its slice
    from every block's slot and writes the sums into its own slot; then
    each thread reads group 128 i + t from its owner's slot."""
    nb = x.shape[0]
    slot = slots(x)
    for r, (a, b) in enumerate(fa.exchange_slices(nb)):
        order = [r, *(q for q in range(nb) if q != r)] if own_first else \
            range(nb)
        slot[r, a:b] = rank_order([slot[q, a:b] for q in order])
    groups = np.arange(fa.EXCHANGE_GROUPS)
    owner = np.array([fa.exchange_owner(nb, g) for g in groups])
    back = slot[owner, groups]                          # [group, 4]
    return np.broadcast_to(
        back.reshape(N4, WG, 4).transpose(1, 0, 2).reshape(WG, 4 * N4),
        x.shape)


@pytest.mark.parametrize("nb", SIZES)
def test_slices_cover_each_group_once(nb):
    """Each of the 1,024 groups in exactly one slice, the slices one after
    another, of sizes that differ by at most one group, and its owner the
    block whose slice holds it."""
    count = np.zeros(fa.EXCHANGE_GROUPS, np.int64)
    slices = fa.exchange_slices(nb)
    assert slices[0][0] == 0 and slices[-1][1] == fa.EXCHANGE_GROUPS
    for r, (a, b) in enumerate(slices):
        count[a:b] += 1
        assert b - a in (fa.EXCHANGE_GROUPS // nb,
                         fa.EXCHANGE_GROUPS // nb + 1)
        if r:
            assert a == slices[r - 1][1]
        assert all(fa.exchange_owner(nb, g) == r for g in range(a, b))
    assert (count == 1).all()


@pytest.mark.parametrize("nb", SIZES)
def test_reduce_scatter_sums_bit_for_bit(nb):
    """The threads' sums after the reduce-scatter are the all-gather's
    rank-order sums, bit for bit, in every block; a reduce-scatter that
    added its own partial first would differ."""
    x = partials(nb, 100 + nb)
    want = rank_order(x)                                # [thread, 32]
    got = reduce_scatter(x)
    assert got.dtype == np.float32
    for r in range(nb):
        assert np.array_equal(got[r].view(np.uint32), want.view(np.uint32))
    other = reduce_scatter(x, own_first=True)
    assert not np.array_equal(other[0].view(np.uint32),
                              want.view(np.uint32))


@pytest.mark.parametrize("nb", SPLIT3_SIZES)
def test_two_part_exchange_gives_each_part_back(nb):
    """s and dp (16 floats a thread each, dp at another scale) packed as
    ``keep_partial`` packs them, s then dp, and reduce-scattered in one
    round: a thread's float4 groups 0-3 read back are the rank-order sum of
    s alone and 4-7 that of dp alone, bit for bit, in every block; taken
    the other way round (``take_sums`` with the parts swapped) they are
    not."""
    s = partials(nb, 300 + nb)[..., :16]
    dp = partials(nb, 400 + nb)[..., 16:] * np.float32(2.0 ** 12)
    got = reduce_scatter(np.concatenate([s, dp], axis=-1))
    want_s, want_dp = rank_order(s), rank_order(dp)     # [thread, 16]
    for r in range(nb):
        assert np.array_equal(got[r, :, :16].view(np.uint32),
                              want_s.view(np.uint32))
        assert np.array_equal(got[r, :, 16:].view(np.uint32),
                              want_dp.view(np.uint32))
    assert not np.array_equal(got[0, :, 16:].view(np.uint32),
                              want_s.view(np.uint32))
    assert not np.array_equal(got[0, :, :16].view(np.uint32),
                              want_dp.view(np.uint32))
