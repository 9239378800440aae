from gradus_tpu_torch.transfer.solvers import (
    find_offset_for_radius,
    impact_parameters_for_radius,
    rtheta_to_alphabeta,
)
from gradus_tpu_torch.transfer.cunningham import (
    TransferBranchGrid,
    cunningham_transfer_function,
    transferfunctions,
    interpolated_transfer_branches,
    g_to_gstar,
    gstar_to_g,
)
from gradus_tpu_torch.transfer.cuda_ctf import CudaCTFSolver, get_cuda_ctf_solver
from gradus_tpu_torch.transfer.integration import integrate_lagtransfer, integrate_lineprofile
from gradus_tpu_torch.transfer.tables import (
    CunninghamTransferTable,
    make_transfer_function_table,
    LineProfileModel,
)
