"""`python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`:
run one cell of BENCHMARK.json once (see portbench/run.py)."""

import sys

from portbench.run import main

sys.exit(main())
