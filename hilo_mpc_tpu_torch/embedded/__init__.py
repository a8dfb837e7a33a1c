"""Dependency-free C99 export of the port's controllers and estimators
(PID, LQR, LMPC, NMPC, EKF, MHE), compiled by the host's C compiler."""
from .codegen import (compile_shared, condense_lmpc, find_c_compiler,
                      generate_lmpc_c, generate_lqr_c, generate_pid_c,
                      load_lmpc, load_lqr, load_pid, setup_solver)
from .nmpc_codegen import generate_nmpc_c, load_nmpc
from .ekf_codegen import generate_ekf_c, load_ekf
from .mhe_codegen import generate_mhe_c, load_mhe
