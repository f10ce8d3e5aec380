"""``python -m nextsimdg_tpu_torch``: the model executable."""

import sys

from .runtime.main import main

sys.exit(main())
