from repro_torch.data.pipeline import (SyntheticLM, CorrelatedTaskStream,
                                 make_calibration_set)
