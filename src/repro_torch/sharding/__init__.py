from repro_torch.sharding.rules import (MeshAxes, P, batch_spec,
                                        cache_pspecs, client_pspecs,
                                        mask_pspecs, opt_pspecs,
                                        server_pspecs)
