/* Drop-in reference-compatible C ABI for edipack_tpu_torch.
 *
 * Exports the same symbol names and signatures as the reference's
 * src/c_bindings/edipack_cbindings.h so a C/C++ driver built against the
 * reference links against libedipack_tpu_torch_c.so unchanged.  Implemented
 * in edipack_compat.c on top of the edtpu_* API (edipack_tpu.h) and the
 * Python bridge edipack_tpu_torch/compat.py.
 *
 * ABI notes (verified against the reference's Fortran binding sources,
 * which are the compiled ground truth where the C header disagrees):
 *  - multi-d arrays are Fortran (column-major) ordered
 *  - static observables (dens/docc/mag/phisc/argsc/eimp/phon/ephon) are
 *    real(c_double) buffers (edipack_c_bindings_io.f90:6-55), although the
 *    upstream header declares std::complex<double>* — we follow the f90.
 *  - axis: 0="m", 1="r" (2="t" for chi); typ: 0="n", 1="a"
 *  - lattice bath arrays are (Nlat, Nb) Fortran-order
 *  - the MPI flags (flag_mpi, mpi_lanc) are accepted and ignored: a driver
 *    launched as N processes with WORLD_SIZE, RANK, MASTER_ADDR and
 *    MASTER_PORT set (torchrun --no-python --nproc-per-node N ./driver)
 *    joins one process group at its first call and splits its large
 *    sectors over the ranks, as edipack_tpu.h describes; rank 0 alone
 *    writes files, and finalize_solver leaves the group
 */
#ifndef EDIPACK_COMPAT_H
#define EDIPACK_COMPAT_H

#include <stdint.h>

#ifdef __cplusplus
#include <complex>
typedef std::complex<double> edc;
extern "C" {
#else
#include <stdbool.h>
typedef struct { double re, im; } edc; /* layout-compatible with C99
                                          double _Complex / C++ complex */
#endif

/* -- exported solver globals (reference edipack_cbindings.h:14-60) -------- */
extern int has_ineq;        /* 1: ineq (real-space DMFT) module available   */
extern int normal_complex;
extern double beta, dmft_error, eps, Jh, Jp, Jx, nread, sb_field, Ust,
    wfin, wini, xmax, xmin, xmu;
extern double Uloc[5];
extern int Lfit, Lmats, Lreal, Lpos, Ltau, Nbath, Nloop, Norb, Nph, Nspin,
    Nsuccess;
extern bool chidens_flag, chiexct_flag, chipair_flag, chispin_flag, ed_twin,
    ed_total_ud, rdm_flag;

/* -- input ---------------------------------------------------------------- */
void read_input(char *instr);

/* -- Hloc ----------------------------------------------------------------- */
void ed_set_Hloc_single_N2(edc *Hloc, edc *Hloc_anomalous, int64_t *d);
void ed_set_Hloc_single_N4(edc *Hloc, edc *Hloc_anomalous, int64_t *d);
void ed_set_Hloc_lattice_N2(edc *Hloc, edc *Hloc_anomalous, int64_t *d,
                            int Nlat);
void ed_set_Hloc_lattice_N3(edc *Hloc, edc *Hloc_anomalous, int64_t *d,
                            int Nlat);
void ed_set_Hloc_lattice_N5(edc *Hloc, edc *Hloc_anomalous, int64_t *d,
                            int Nlat);

/* -- bath dimension / aux ------------------------------------------------- */
int get_bath_dimension_direct(void);
int get_bath_dimension_symmetries(int Nsym);
void search_variable(double *var, double *ntmp, int64_t *converged);
void ed_set_A_ph(double *A_new);
void ed_set_G_ph(edc *G_new);

/* -- replica/general bath bases ------------------------------------------ */
void init_Hreplica_symmetries_d3(edc *Hvec, int64_t *d_hvec,
                                 double *lambdavec, int64_t *d_lambdavec);
void init_Hreplica_symmetries_d5(edc *Hvec, int64_t *d_hvec,
                                 double *lambdavec, int64_t *d_lambdavec);
void init_Hgeneral_symmetries_d3(edc *Hvec, int64_t *d_hvec,
                                 double *lambdavec, int64_t *d_lambdavec);
void init_Hgeneral_symmetries_d5(edc *Hvec, int64_t *d_hvec,
                                 double *lambdavec, int64_t *d_lambdavec);
void init_Hreplica_symmetries_lattice_d3(edc *Hvec, int64_t *d_hvec,
                                         double *lambdavec,
                                         int64_t *d_lambdavec);
void init_Hreplica_symmetries_lattice_d5(edc *Hvec, int64_t *d_hvec,
                                         double *lambdavec,
                                         int64_t *d_lambdavec);
void init_Hgeneral_symmetries_lattice_d3(edc *Hvec, int64_t *d_hvec,
                                         double *lambdavec,
                                         int64_t *d_lambdavec);
void init_Hgeneral_symmetries_lattice_d5(edc *Hvec, int64_t *d_hvec,
                                         double *lambdavec,
                                         int64_t *d_lambdavec);

/* -- bath symmetry operations --------------------------------------------- */
void break_symmetry_bath_site(double *bath, int64_t *dim_bath, double field,
                              double sgn, int sav);
void break_symmetry_bath_ineq(double *bath, int64_t *dim_bath, double field,
                              double *sgn, int sav);
void spin_symmetrize_bath_site(double *bath, int64_t *dim_bath, int sav);
void spin_symmetrize_bath_ineq(double *bath, int64_t *dim_bath, int sav);
void orb_symmetrize_bath_site(double *bath, int64_t *dim_bath, int orb1,
                              int orb2, int sav);
void orb_symmetrize_bath_ineq(double *bath, int64_t *dim_bath, int orb1,
                              int orb2, int sav);
void orb_equality_bath_site(double *bath, int64_t *dim_bath, int indx,
                            int sav);
void orb_equality_bath_ineq(double *bath, int64_t *dim_bath, int indx,
                            int sav);
void ph_symmetrize_bath_site(double *bath, int64_t *dim_bath, int sav);
void ph_symmetrize_bath_ineq(double *bath, int64_t *dim_bath, int sav);
void save_array_as_bath_site(double *bath, int64_t *dim_bath);
void save_array_as_bath_ineq(double *bath, int64_t *dim_bath);

/* -- chi^2 bath fits ------------------------------------------------------ */
void chi2_fitgf_single_normal_n3(edc *g, int64_t *dim_g, double *bath,
                                 int64_t *dim_bath, int ispin, int iorb,
                                 int fmpi);
void chi2_fitgf_single_normal_n5(edc *g, int64_t *dim_g, double *bath,
                                 int64_t *dim_bath, int ispin, int iorb,
                                 int fmpi);
void chi2_fitgf_single_superc_n3(edc *g, int64_t *dim_g, edc *f,
                                 int64_t *dim_f, double *bath,
                                 int64_t *dim_bath, int ispin, int iorb,
                                 int fmpi);
void chi2_fitgf_single_superc_n5(edc *g, int64_t *dim_g, edc *f,
                                 int64_t *dim_f, double *bath,
                                 int64_t *dim_bath, int ispin, int iorb,
                                 int fmpi);
void chi2_fitgf_lattice_normal_n3(edc *g, int64_t *dim_g, double *bath,
                                  int64_t *dim_bath, int ispin);
void chi2_fitgf_lattice_normal_n4(edc *g, int64_t *dim_g, double *bath,
                                  int64_t *dim_bath, int ispin);
void chi2_fitgf_lattice_normal_n6(edc *g, int64_t *dim_g, double *bath,
                                  int64_t *dim_bath, int ispin);
void chi2_fitgf_lattice_superc_n3(edc *g, int64_t *dim_g, edc *f,
                                  int64_t *dim_f, double *bath,
                                  int64_t *dim_bath, int ispin);
void chi2_fitgf_lattice_superc_n4(edc *g, int64_t *dim_g, edc *f,
                                  int64_t *dim_f, double *bath,
                                  int64_t *dim_bath, int ispin);
void chi2_fitgf_lattice_superc_n6(edc *g, int64_t *dim_g, edc *f,
                                  int64_t *dim_f, double *bath,
                                  int64_t *dim_bath, int ispin);

/* -- static observables (real buffers, see ABI note) ---------------------- */
void ed_get_dens_n1(double *self);
void ed_get_dens_n2(double *self, int Nlat);
void ed_get_mag_n2(double *self);
void ed_get_mag_n3(double *self, int Nlat);
void ed_get_docc_n1(double *self);
void ed_get_docc_n2(double *self, int Nlat);
void ed_get_phisc_n2(double *self);
void ed_get_phisc_n3(double *self, int Nlat);
void ed_get_argsc_n2(double *self);
void ed_get_argsc_n3(double *self, int Nlat);
void ed_get_eimp_n1(double *self);
void ed_get_eimp_n2(double *self, int Nlat);
void ed_get_phon(double *self);
void ed_get_ephon(double *self);

/* -- dynamical functions -------------------------------------------------- */
void get_sigma_site_n3(edc *self, int axis, int typ, edc *zeta, int dz,
                       int zflag);
void get_sigma_site_n5(edc *self, int axis, int typ, edc *zeta, int dz,
                       int zflag);
void get_sigma_lattice_n3(edc *self, int Nineq, int axis, int typ, edc *zeta,
                          int dz, int zflag);
void get_sigma_lattice_n4(edc *self, int Nineq, int axis, int typ, edc *zeta,
                          int dz, int zflag);
void get_sigma_lattice_n6(edc *self, int Nineq, int axis, int typ, edc *zeta,
                          int dz, int zflag);
void get_gimp_site_n3(edc *gimp, int axis, int typ, edc *zeta, int dz,
                      int zflag);
void get_gimp_site_n5(edc *gimp, int axis, int typ, edc *zeta, int dz,
                      int zflag);
void get_gimp_lattice_n3(edc *gimp, int Nineq, int axis, int typ, edc *zeta,
                         int dz, int zflag);
void get_gimp_lattice_n4(edc *gimp, int Nineq, int axis, int typ, edc *zeta,
                         int dz, int zflag);
void get_gimp_lattice_n6(edc *gimp, int Nineq, int axis, int typ, edc *zeta,
                         int dz, int zflag);
void get_dimp_site_n1(edc *dimp, int axis, edc *zeta, int dz, int zflag);
void get_dimp_lattice_n2(edc *dimp, int Nineq, int axis, edc *zeta, int dz,
                         int zflag);
void get_g0and_n3(edc *warray, int64_t *dim_warray, double *bath,
                  int dim_bath, edc *G0and, int64_t *dim_g0and, char *axis,
                  char *typ);
void get_g0and_n5(edc *warray, int64_t *dim_warray, double *bath,
                  int dim_bath, edc *G0and, int64_t *dim_g0and, char *axis,
                  char *typ);
void get_delta_n3(edc *warray, int64_t *dim_warray, double *bath,
                  int dim_bath, edc *Delta, int64_t *dim_delta, char *axis,
                  char *typ);
void get_delta_n5(edc *warray, int64_t *dim_warray, double *bath,
                  int dim_bath, edc *Delta, int64_t *dim_delta, char *axis,
                  char *typ);

/* -- susceptibilities ----------------------------------------------------- */
void ed_get_spinchi(edc *self, edc *zeta, int dim_zeta, int zetaflag,
                    char *axis, int Nsites, int latticeflag);
void ed_get_denschi(edc *self, edc *zeta, int dim_zeta, int zetaflag,
                    char *axis, int Nsites, int latticeflag);
void ed_get_pairchi(edc *self, edc *zeta, int dim_zeta, int zetaflag,
                    char *axis, int Nsites, int latticeflag);
void ed_get_exctchi(edc *self, edc *zeta, int dim_zeta, int zetaflag,
                    char *axis, int Nsites, int latticeflag);

/* -- density matrices ----------------------------------------------------- */
void ed_get_impurity_rdm(edc *rdm, int doprint);
void ed_get_denmat_n2(edc *denmat, int64_t *dimdenmat, int doprint);
void ed_get_denmat_n4(edc *denmat, int64_t *dimdenmat, int doprint);

/* -- lifecycle ------------------------------------------------------------ */
void init_solver_site(double *bath, int64_t *dim_bath);
void init_solver_site_nobath(void);
void init_solver_ineq(double *bath, int64_t *dim_bath);
void init_solver_ineq_nobath(int Nlat);
void solve_site(double *bath, int64_t *dim_bath, int flag_gf, int flag_mpi);
void solve_site_nobath(int flag_gf, int flag_mpi);
void solve_ineq(double *bath, int64_t *dim_bath, int flag_gf, int mpi_lanc);
void solve_ineq_nobath(int Nlat, int flag_gf, int mpi_lanc);
void finalize_solver(int Nineq);

/* -- runtime interaction terms -------------------------------------------- */
void reset_umatrix(void);
void add_twobody_operator(int o1, int s1, int o2, int s2, int o3, int s3,
                          int o4, int s4, double U);

#ifdef __cplusplus
}
#endif
#endif /* EDIPACK_COMPAT_H */
