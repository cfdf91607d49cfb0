#!/usr/bin/env python3
"""The former name of ``tools/torch_kernel_ab.py``, which it runs with the
same arguments:

    python3 tools/torch_attention_ab.py [--root TREE] [--label NAME] [--parts ...]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_kernel_ab import main  # noqa: E402

if __name__ == "__main__":
    main()
