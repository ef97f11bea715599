import sys

from swimm_tpu_torch.cli import main

sys.exit(main())
