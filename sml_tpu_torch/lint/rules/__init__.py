"""The port's torchlint rules. Importing this package registers them all
in `core.RULES`; add a rule by dropping a module here that uses the
`@rule(name, doc)` decorator and importing it below."""

from . import (collective_axis, conf_keys, divergent_collective,  # noqa: F401
               host_sync, kernel_launch, key_fold, lock_order,
               race_check_use, race_shared_write, taxonomy, wallclock)
