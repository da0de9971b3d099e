"""The flax→torch weight bridge is strict: every leaf of a bundled
checkpoint fills exactly one parameter or buffer, and a checkpoint with a
leaf missing or a leaf too many is refused."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from person_capture_tpu_torch.models import arcface as AF  # noqa: E402
from person_capture_tpu_torch.models import bridge as B  # noqa: E402
from person_capture_tpu_torch.models import scrfd as SD  # noqa: E402
from person_capture_tpu_torch.models import yolov8 as YV  # noqa: E402
from person_capture_tpu_torch.models.zoo import (  # noqa: E402
    bundled_weights_path, resolve_weights)
from person_capture_tpu_torch.tools.weights import (  # noqa: E402
    flatten_tree, unflatten_tree)

CASES = {
    "scrfd_2.5g": (lambda: SD.SCRFD(SD.SCRFD_2_5G), B.load_scrfd),
    "scrfd_tiny": (lambda: SD.SCRFD(SD.TINY), B.load_scrfd),
    "arcface_synth": (lambda: AF.IResNet(AF.SYNTH_R18), B.load_arcface),
    # YOLOv8n has 297 leaves; the face models add the keypoint branches
    **{name: (lambda name=name: YV.YoloV8(YV.CONFIGS[name]), B.load_yolov8)
       for name in ("yolov8n", "yolo_tiny", "yolov8n_face",
                    "yolo_face_tiny")},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bundled_checkpoint_fills_every_tensor(name):
    assert bundled_weights_path(name) is not None
    variables = resolve_weights("auto", name)
    make, load = CASES[name]
    model = load(make(), variables)
    flat = flatten_tree(variables)
    sd = model.state_dict()
    n_tensors = sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    assert n_tensors == len(flat)
    # spot-check the layout conversions: conv HWIO→OIHW, BN running stats
    if name.startswith("scrfd"):
        np.testing.assert_array_equal(
            sd["backbone.stem.conv.weight"].numpy(),
            flat["params/_Backbone_0/ConvBN_0/Conv_0/kernel"]
            .transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(
            sd["backbone.stem.bn.running_var"].numpy(),
            flat["batch_stats/_Backbone_0/ConvBN_0/BatchNorm_0/var"])
    elif name.startswith("yolo"):
        np.testing.assert_array_equal(
            sd["stem.conv.weight"].numpy(),
            flat["params/ConvSiLU_0/Conv_0/kernel"].transpose(3, 2, 0, 1))
        # the level-0 class conv is the second head Conv
        np.testing.assert_array_equal(sd["heads.0.cls.2.bias"].numpy(),
                                      flat["params/Conv_1/bias"])
        if name == "yolov8n":
            assert len(flat) == 297
    else:
        np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                      flat["params/Dense_0/kernel"].T)
        np.testing.assert_array_equal(sd["prelu.alpha"].numpy(),
                                      flat["params/PReLU_0/alpha"])


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("change", ["missing", "extra"])
def test_checkpoint_mismatch_raises(name, change):
    flat = flatten_tree(resolve_weights("auto", name))
    if change == "missing":
        flat.pop(sorted(flat)[len(flat) // 2])
    else:
        flat["params/Unused_0/kernel"] = np.zeros((3, 3), np.float32)
    make, load = CASES[name]
    with pytest.raises(KeyError):
        load(make(), unflatten_tree(flat))
