"""HALCONE core for the PyTorch port: the timestamp-coherence protocol, the
array state layer, the vectorised MGPU memory-hierarchy simulator (the
figure engine), system configs and trace generators."""
from repro_torch.core import protocol, state, traces  # noqa: F401
from repro_torch.core.engine import (COMPUTE, FENCE, NOP,  # noqa: F401
                                     READ, WRITE, SimState, init_state,
                                     simulate, sweep)
from repro_torch.core.sysconfig import (ALL_CONFIGS,  # noqa: F401
                                        SystemConfig, rdma_wb_hmg,
                                        rdma_wb_nc, sm_wb_nc, sm_wt_halcone,
                                        sm_wt_nc, stack_configs, static_key)
