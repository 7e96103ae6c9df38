/* piqp_tpu C interface.
 *
 * C-callable surface over the JAX solver — full-parity analog of the
 * reference's C interface (/root/reference/interfaces/c/include/piqp.h:21-43
 * function surface; piqp_typedef.h:27-196 data/settings/info structs define
 * the shape being mirrored).  This is a fresh implementation embedding the
 * Python runtime, since Python is the host language of the JAX framework
 * the way C++ is the reference's.
 *
 * Threading: calls must come from one thread (the embedded interpreter
 * owns the device runtime).  Dense matrices are row-major double arrays;
 * sparse matrices are CSC with int indices (piqp_typedef.h:27-33).
 */
#ifndef PIQP_TPU_C_H
#define PIQP_TPU_C_H

#ifdef __cplusplus
extern "C" {
#endif

#ifndef PIQP_TPU_INF
#define PIQP_TPU_INF 1e30
#endif

typedef struct piqp_tpu_workspace piqp_tpu_workspace; /* opaque */

/* Compressed sparse column matrix (mirror of piqp_csc,
 * piqp_typedef.h:27-33).  Pointers are borrowed for the duration of the
 * setup/update call. */
typedef struct {
    int m;           /* rows */
    int n;           /* cols */
    int nnz;         /* non-zeros */
    const int* p;    /* column pointers (size n+1) */
    const int* i;    /* row indices (size nnz) */
    const double* x; /* values (size nnz) */
} piqp_tpu_csc;

typedef struct {
    /* min 0.5 x'Px + c'x  s.t. Ax=b, h_l <= Gx <= h_u, x_l <= x <= x_u.
     * P: n*n row-major (upper triangle used); A: p*n; G: m*n.
     * Any of A/b/G/h_l/h_u/x_l/x_u may be NULL (p/m 0 as applicable;
     * NULL bounds mean +/- infinity). */
    const double* P;
    const double* c;
    const double* A;
    const double* b;
    const double* G;
    const double* h_l;
    const double* h_u;
    const double* x_l;
    const double* x_u;
    int n;
    int p;
    int m;
} piqp_tpu_dense_data;

/* Sparse problem (mirror of piqp_data_sparse, piqp_typedef.h:52-66). */
typedef struct {
    const piqp_tpu_csc* P; /* upper triangle used */
    const double* c;
    const piqp_tpu_csc* A; /* may be NULL */
    const double* b;
    const piqp_tpu_csc* G; /* may be NULL */
    const double* h_l;
    const double* h_u;
    const double* x_l;
    const double* x_u;
    int n;
    int p;
    int m;
} piqp_tpu_sparse_data;

/* KKT backend selector (mirror of piqp_kkt_solver, piqp_typedef.h:68-75;
 * the three sparse elimination modes condense to the same device system in
 * this framework and map to the condensed backend). */
typedef enum {
    PIQP_TPU_DENSE_CHOLESKY = 0,
    PIQP_TPU_SPARSE_LDLT = 1,          /* host sparse LDLt backend */
    PIQP_TPU_SPARSE_LDLT_EQ_COND = 2,  /* -> condensed device backend */
    PIQP_TPU_SPARSE_LDLT_INEQ_COND = 3,/* -> condensed device backend */
    PIQP_TPU_SPARSE_LDLT_COND = 4,     /* -> condensed device backend */
    PIQP_TPU_SPARSE_MULTISTAGE = 5,
    PIQP_TPU_DENSE_LU = 6,             /* extension: full-KKT dense LU */
    PIQP_TPU_DENSE_LDLT = 7,           /* extension: full-KKT signed
                                        * Cholesky (LDL^T no-pivot), f64 on
                                        * device */
    PIQP_TPU_AUTO = -1                 /* let the router decide (sparse) */
} piqp_tpu_kkt_solver;

/* Full settings mirror (piqp_settings, piqp_typedef.h:77-115) plus
 * the device extensions at the tail. */
typedef struct {
    double rho_init;                       /* 1e-6 */
    double delta_init;                     /* 1e-4 */
    double eps_abs;                        /* 1e-8 */
    double eps_rel;                        /* 1e-9 */
    int check_duality_gap;                 /* 1 */
    double eps_duality_gap_abs;            /* 1e-8 */
    double eps_duality_gap_rel;            /* 1e-9 */
    double infeasibility_threshold;        /* 0.9 */
    double reg_lower_limit;                /* 1e-10 */
    double reg_finetune_lower_limit;       /* 1e-13 */
    int reg_finetune_primal_update_threshold; /* 7 */
    int reg_finetune_dual_update_threshold;   /* 7 */
    int max_iter;                          /* 250 */
    int max_factor_retires;                /* 10 */
    int preconditioner_scale_cost;         /* 0 */
    int preconditioner_reuse_on_update;    /* 0 */
    int preconditioner_iter;               /* 10 */
    double tau;                            /* 0.99 */
    piqp_tpu_kkt_solver kkt_solver;        /* DENSE_CHOLESKY / AUTO */
    int iterative_refinement_always_enabled;      /* 0 */
    double iterative_refinement_eps_abs;          /* 1e-12 */
    double iterative_refinement_eps_rel;          /* 1e-12 */
    int iterative_refinement_max_iter;            /* 10 */
    double iterative_refinement_min_improvement_rate;    /* 5.0 */
    double iterative_refinement_static_regularization_eps; /* 1e-8 */
    double iterative_refinement_static_regularization_rel; /* eps^2; <0 -> default */
    int verbose;                           /* 0 */
    int compute_timings;                   /* 0 */
    /* --- device extensions (types.py Settings) --- */
    int use_float32;                       /* 0: f64 solver dtype */
    int mixed_precision;                   /* 0: f32 factors + refinement */
    int pallas_kernels;                    /* 0: plain Cholesky factor; 1: factor
                                              with its triangular inverse */
    double refine_mu_factor;               /* 1e-2: inexact-IPM refinement
                                              tolerance (0 = fixed 1e-12) */
    int refine_static_passes;              /* 1: fixed phase-A refinement
                                              passes (-1 = adaptive loop) */
    int mixed_phase_a_patience;            /* 12: phase-A stall exit after
                                              this many no-progress iters
                                              (0 = disabled) */
} piqp_tpu_settings;

/* Full info mirror (piqp_info, piqp_typedef.h:117-160). */
typedef struct {
    int status;      /* piqp status code (1 = solved) */
    int iter;
    double rho;
    double delta;
    double mu;
    double sigma;
    double primal_step;
    double dual_step;
    double primal_res;
    double primal_res_rel;
    double dual_res;
    double dual_res_rel;
    double primal_res_reg;
    double primal_res_reg_rel;
    double dual_res_reg;
    double dual_res_reg_rel;
    double primal_prox_inf;
    double dual_prox_inf;
    double prev_primal_res;
    double prev_dual_res;
    double primal_obj;
    double dual_obj;
    double duality_gap;
    double duality_gap_rel;
    int factor_retires;
    double reg_limit;
    int no_primal_update;
    int no_dual_update;
    double setup_time;
    double update_time;
    double solve_time;
    double kkt_factor_time;
    double kkt_solve_time;
    double run_time;
} piqp_tpu_info;

/* Result views (piqp_result, piqp_typedef.h:162-176): primal/dual
 * solution plus slacks.  Views owned by the workspace; valid until the
 * next solve/free. */
typedef struct {
    const double* x;    /* n */
    const double* y;    /* p */
    const double* z_l;  /* m */
    const double* z_u;  /* m */
    const double* z_bl; /* n */
    const double* z_bu; /* n */
    const double* s_l;  /* m */
    const double* s_u;  /* m */
    const double* s_bl; /* n */
    const double* s_bu; /* n */
    piqp_tpu_info info;
    /* kept for source compatibility with the round-1 header */
    int status;
    int iter;
    double primal_obj;
    double primal_res;
    double dual_res;
} piqp_tpu_result;

/* Fill settings with the library defaults (mirror of
 * piqp_set_default_settings_dense/sparse). */
void piqp_tpu_settings_default(piqp_tpu_settings* s);

/* Create a workspace from dense problem data.  Returns NULL on error
 * (piqp_tpu_last_error() describes it). */
piqp_tpu_workspace* piqp_tpu_setup_dense(const piqp_tpu_dense_data* data,
                                         const piqp_tpu_settings* settings);

/* Create a workspace from sparse (CSC) problem data; routes through the
 * SparseSolver's structure detection (multistage / condensed-dense / host
 * backends).  Returns NULL on error. */
piqp_tpu_workspace* piqp_tpu_setup_sparse(const piqp_tpu_sparse_data* data,
                                          const piqp_tpu_settings* settings);

/* Update problem values in place (shapes must match setup; NULL fields
 * keep their current values).  Returns 0 on success. */
int piqp_tpu_update_dense(piqp_tpu_workspace* w,
                          const piqp_tpu_dense_data* data);

/* Sparse value update: CSC patterns must match the setup call
 * (solver.hpp:318-359 semantics).  Returns 0 on success. */
int piqp_tpu_update_sparse(piqp_tpu_workspace* w,
                           const piqp_tpu_sparse_data* data);

/* Replace the solver settings (mirror of piqp_update_settings).
 * Returns 0 on success. */
int piqp_tpu_update_settings(piqp_tpu_workspace* w,
                             const piqp_tpu_settings* settings);

/* Read back the workspace's current settings.  Returns 0 on success. */
int piqp_tpu_get_settings(piqp_tpu_workspace* w, piqp_tpu_settings* out);

/* Solve; returns the status code (1 = solved) or -100 on internal error. */
int piqp_tpu_solve(piqp_tpu_workspace* w);

/* Solve seeded from the previous solve's iterates (extension over the
 * reference C API, which always cold-starts; ~3x fewer IPM iterations on
 * small data updates — see docs/batching.md).  Falls back to a cold solve
 * when no previous result exists.  Returns the status code. */
int piqp_tpu_solve_warm(piqp_tpu_workspace* w);

/* Result views for the last solve.  Returns 0 on success. */
int piqp_tpu_get_result(piqp_tpu_workspace* w, piqp_tpu_result* out);

/* Destroy the workspace. */
void piqp_tpu_free(piqp_tpu_workspace* w);

/* Last error message (static buffer). */
const char* piqp_tpu_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* PIQP_TPU_C_H */
