from repro_torch.data.synthetic import (ClsTask, ClsTaskConfig, LMStream,
                                        LMStreamConfig, make_embedding_batch)
