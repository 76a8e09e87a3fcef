import sys

from plutracer_tpu_torch.cli import main

sys.exit(main())
