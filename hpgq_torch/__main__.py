import sys

from hpgq_torch.cli.main import main

sys.exit(main())
