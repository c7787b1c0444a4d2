from repro_torch.parallel.sharding import (constrain, named_sharding_tree,
                                           param_spec_tree, spec, use_rules)
