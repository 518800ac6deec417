"""Export a detector checkpoint to a self-contained serving artifact with
the PyTorch port.

Thin wrapper over ``avd_tpu_torch.models.export.main``; see that module for
the artifact format.  Serve the output with ``AVD_DETECTOR=1
AVD_DETECTOR_EXPORTED=<out>``.

    python tools/torch_export_detector.py --out DIR [--arch vit|cnn|temporal]
        [--preset P] [--ckpt DIR|auto|none] [--device cuda|cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from avd_tpu_torch.models.export import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())
