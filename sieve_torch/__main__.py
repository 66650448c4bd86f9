import sys

from sieve_torch.cli import main

sys.exit(main())
