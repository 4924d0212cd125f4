"""PASCAL VOC2012 segmentation dataset (reference
python/paddle/dataset/voc2012.py).

Samples: (image [3, H, W] float32 in [0,1], label_mask [H, W] int32 with
class ids 0..20, 255 = void border). The reference decodes JPEG/PNG pairs;
the synthetic fallback paints class rectangles whose pixel statistics
correlate with their class id, so segmentation models have learnable
signal at identical shapes/dtypes.
"""

import numpy as np

from . import common

__all__ = ["train", "test", "val"]

NUM_CLASSES = 21
H = W = 64  # synthetic resolution (the reference resizes anyway)
TRAIN_SIZE = 256
TEST_SIZE = 64


def _reader(split, size):
    def reader():
        rs = common.synthetic_rng("voc2012", split)
        for _ in range(size):
            img = rs.rand(3, H, W).astype(np.float32) * 0.2
            mask = np.zeros((H, W), np.int32)
            for _obj in range(int(rs.randint(1, 4))):
                c = int(rs.randint(1, NUM_CLASSES))
                y0, x0 = rs.randint(0, H // 2), rs.randint(0, W // 2)
                h, w = rs.randint(8, H // 2), rs.randint(8, W // 2)
                mask[y0:y0 + h, x0:x0 + w] = c
                # class-correlated appearance
                img[:, y0:y0 + h, x0:x0 + w] = (
                    np.asarray([c, (c * 3) % NUM_CLASSES,
                                (c * 7) % NUM_CLASSES], np.float32)
                    .reshape(3, 1, 1) / NUM_CLASSES
                    + rs.rand(3, h, w).astype(np.float32) * 0.1)
            # void border (255) like the real annotations
            mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = 255
            yield img, mask

    return reader


def train():
    return _reader("train", TRAIN_SIZE)


def test():
    return _reader("test", TEST_SIZE)


def val():
    return _reader("val", TEST_SIZE)
