"""perfbench/calibrate.py with the faults of the detector's cell besides:

    python3 perfbench/calibrate_detect.py --workload chain_maskrcnn.fresh \
        --seeds 1,2,3 --seconds 5 [--control] [--fault <name>]

The three faults below are planted in the program's detector for every
run; perfbench/tests/test_pb_detect.py plants the same ones."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import calibrate  # noqa: E402


def level_dropped():
    """The pyramid without its top level (P6): the RPN runs on P2..P5."""
    from sdn3d_tpu_torch.models.maskrcnn import FPN
    return calibrate._patched(
        FPN, "forward", lambda real: lambda self, x: real(self, x)[:4])


def rpn_nms_loose():
    """The RPN's NMS at 0.6, where the configuration says 0.7."""
    import dataclasses

    from sdn3d_tpu_torch.models import maskrcnn

    def make(real):
        def proposal_layer(probs, bbox, anchors, config, count):
            return real(probs, bbox, anchors, dataclasses.replace(
                config, rpn_nms_threshold=0.6), count)
        return proposal_layer
    return calibrate._patched(maskrcnn, "proposal_layer", make)


def plane_swapped():
    """Each detection's mask plane taken from the other foreground class
    (car for van, van for car); its box, class and score kept."""
    import torch

    from sdn3d_tpu_torch.pipelines import detect

    def make(real):
        def pack_outputs(out):
            dets = out["detections"]
            cid = dets[..., 4:5]
            other = real(dict(out, detections=torch.cat(
                [dets[..., :4], (cid > 0) * (3 - cid), dets[..., 5:]], -1)))
            head = dets.shape[1] * 7          # detections and validity
            return torch.cat([real(out)[:, :head], other[:, head:]], 1)
        return pack_outputs
    return calibrate._patched(detect, "pack_outputs", make)


FAULTS = {f.__name__: f for f in (level_dropped, rpn_nms_loose,
                                   plane_swapped)}


if __name__ == "__main__":
    calibrate.FAULTS.update(FAULTS)
    sys.exit(calibrate.main())
