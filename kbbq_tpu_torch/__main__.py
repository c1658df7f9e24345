"""``python -m kbbq_tpu_torch`` entry point."""

import sys

from .cli.main import main

sys.exit(main())
