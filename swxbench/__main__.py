import sys

from swxbench.run import main

sys.exit(main())
