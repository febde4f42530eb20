"""The host-side launch logic of the cascade and chain kernels
(clrs_tpu_torch.dd.kernels), as pure functions on the CPU: the cascade's
tile choice and the chains' block shape and operand classification. The
kernels themselves run only on the card (tests/test_torch_gpu.py,
chip_smoke.py). Imports nothing of JAX.
"""

import pytest
import torch

from clrs_tpu_torch.dd import kernels as K

H100_SMS = 132


@pytest.mark.parametrize("nw", [5, 6, 7, 8])
@pytest.mark.parametrize("B, m, n", [(4, 22, 22), (1, 100, 130), (1, 1, 1),
                                     (300, 11, 11), (1, 192, 192),
                                     (2, 64, 96), (1, 21, 1)])
def test_cascade_tile_covers_sms_within_shared_memory(nw, B, m, n):
    """A power of two in CASCADE_TILE_MIN..MAX; its blocks cover the SMs
    unless it is the smallest, and twice the tile would not; a block's
    staged limb pairs and diagonal sums fit in shared memory."""
    tile = K.cascade_tile(B, m, n, H100_SMS)
    assert tile & (tile - 1) == 0
    assert K.CASCADE_TILE_MIN <= tile <= K.CASCADE_TILE_MAX

    def blocks(t):
        return B * -(-(m * n) // t)

    assert blocks(tile) >= H100_SMS or tile == K.CASCADE_TILE_MIN
    if tile < K.CASCADE_TILE_MAX:
        assert blocks(2 * tile) < H100_SMS
    # within the 227 KiB a block may take on sm_90, and threads within 1024
    assert K.cascade_smem_bytes(nw, tile) <= 227 * 1024
    assert tile * K.cascade_slices(nw) <= 1024
    if (B, m, n) == (4, 22, 22):
        assert tile == 8 and blocks(tile) == 244


@pytest.mark.parametrize("D2, tx", [(96, 32), (11, 16), (64, 32), (22, 8),
                                    (1, 8), (130, 8), (192, 32), (95, 32)])
def test_plmap_block_covers_columns_with_least_idle(D2, tx):
    got = K.plmap_block(D2)
    assert got == tx
    cols = -(-D2 // got) * got
    assert cols >= D2
    for other in (8, 16, 32):
        assert cols - D2 <= -(-D2 // other) * other - D2


def _words(shape, nw=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g) for _ in range(nw))


def _kind(op, shape3):
    return K.plmap_operand(op, shape3)[0]


def test_plmap_operand_kinds():
    """Contiguous and sliced planes, [L, 1, 1] scalars, transposed and
    mixed views, word-major stacks as the step's words lie, a matrix
    broadcast over L and a column broadcast along j."""
    s96, s11 = (2, 96, 96), (2, 11, 11)
    assert _kind(_words(s96), s96) == K.OP_PLANE
    assert _kind(_words(s11), s11) == K.OP_PLANE
    mu = tuple(c.reshape(1, 1, 1).expand(2, 1, 1) for c in _words((1,)))
    kind, words = K.plmap_operand(mu, s96)
    assert kind == K.OP_SCALAR and words[0][1] == (0, 0, 0)
    kind, words = K.plmap_operand(_words((2, 1, 1)), s96)
    assert kind == K.OP_SCALAR and words[0][1] == (1, 0, 0)
    assert _kind(tuple(c.transpose(1, 2) for c in _words(s96)), s96) \
        == K.OP_GENERAL
    # slices: unit column stride, a longer row, an offset pointer
    sl = tuple(c[:, :, 1:] for c in _words((2, 96, 97)))
    kind, words = K.plmap_operand(sl, s96)
    assert kind == K.OP_PLANE and words[0][1] == (96 * 97, 97, 1)
    assert words[0][0] == sl[0].data_ptr()
    assert _kind(tuple(c[:, ::2, :] for c in _words((2, 192, 96))), s96) \
        == K.OP_PLANE
    assert _kind(tuple(c[:, :, ::2] for c in _words((2, 96, 192))), s96) \
        == K.OP_GENERAL
    # words of one operand with different strides
    mixed = _words(s96)[:4] + (_words(s96)[0].transpose(1, 2),)
    assert _kind(mixed, s96) == K.OP_GENERAL
    # the step's words: views of one word-major [L, nw, n, n] stack
    stack = torch.randn(2, 5, 96, 96)
    kind, words = K.plmap_operand(tuple(stack[:, w] for w in range(5)), s96)
    assert kind == K.OP_PLANE and words[0][1] == (5 * 96 * 96, 96, 1)
    # a matrix shared by every l (stride 0 over L)
    shared = tuple(c.expand(2, 96, 96) for c in _words((1, 96, 96)))
    kind, words = K.plmap_operand(shared, s96)
    assert kind == K.OP_PLANE and words[0][1] == (0, 96, 1)
    # a column [L, n, 1] broadcast along j
    assert _kind(_words((2, 96, 1)), s96) == K.OP_GENERAL


def test_plmap_operand_refuses_planes_beyond_32_bits():
    big = torch.empty((1,), device="meta").as_strided((2, 3, 3),
                                                      (0, 1 << 30, 1))
    with pytest.raises(ValueError, match="32 bits"):
        K.plmap_operand((big,), (2, 3, 3))
