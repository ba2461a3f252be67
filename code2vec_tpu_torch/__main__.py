"""`python3 -m code2vec_tpu_torch`: the command line (cli.py), its log on
standard output."""

import logging
import sys

from code2vec_tpu_torch.cli import main

if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(levelname)s %(message)s")
    sys.exit(main())
