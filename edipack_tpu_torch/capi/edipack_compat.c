/* Reference-compatible C ABI (see edipack_compat.h) over
 * edipack_tpu_torch.
 *
 * Each exported function zero-copy-wraps the caller's buffers as numpy
 * arrays (np.frombuffer over a PyMemoryView) and dispatches to
 * edipack_tpu_torch/compat.py, which owns all reshaping (Fortran order) and
 * engine calls and writes results in place.  As in the reference, these
 * functions return nothing: a Python error is printed (PyErr_Print) to
 * stderr and the calling program goes on.  Module-level solver globals
 * (Norb, beta, ...) are mirrored as real C globals with push/pull
 * synchronisation against the EDConfig, matching the reference's live
 * bind(c) Fortran module variables.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdbool.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include "edipack_tpu.h"
#include "edipack_compat.h"

/* ---------------- exported globals + shadows --------------------------- */
#define GLOBAL_DBL(X)                                                       \
  X(beta) X(dmft_error) X(eps) X(Jh) X(Jp) X(Jx) X(nread) X(sb_field)       \
  X(Ust) X(wfin) X(wini) X(xmax) X(xmin) X(xmu)
#define GLOBAL_INT(X)                                                       \
  X(Lfit) X(Lmats) X(Lreal) X(Lpos) X(Ltau) X(Nbath) X(Nloop) X(Norb)       \
  X(Nph) X(Nspin) X(Nsuccess)
#define GLOBAL_BOOL(X)                                                      \
  X(chidens_flag) X(chiexct_flag) X(chipair_flag) X(chispin_flag)           \
  X(ed_twin) X(ed_total_ud) X(rdm_flag)

#define DEF_DBL(n) double n; static double sh_##n;
#define DEF_INT(n) int n; static int sh_##n;
#define DEF_BOOL(n) bool n; static bool sh_##n;
GLOBAL_DBL(DEF_DBL)
GLOBAL_INT(DEF_INT)
GLOBAL_BOOL(DEF_BOOL)
double Uloc[5];
static double sh_Uloc[5];
int has_ineq = 1;
int normal_complex = 0;

/* ---------------- python plumbing -------------------------------------- */
static PyObject *g_compat = NULL;

static PyObject *compat_mod(void) {
  if (!g_compat) g_compat = PyImport_ImportModule("edipack_tpu_torch.compat");
  if (!g_compat) PyErr_Print();
  return g_compat;
}

/* wrap `count` items at p as a 1-D numpy array sharing the caller's
 * memory; dtype is "float64"/"complex128"/"int64" */
static PyObject *wrap(const void *p, Py_ssize_t count, const char *dtype,
                      int writable) {
  Py_ssize_t isz = strcmp(dtype, "complex128") == 0 ? 16 : 8;
  PyObject *mv = PyMemoryView_FromMemory(
      (char *)p, count * isz, writable ? PyBUF_WRITE : PyBUF_READ);
  if (!mv) return NULL;
  PyObject *arr =
      PyObject_CallMethod(compat_mod(), "frombuffer", "Os", mv, dtype);
  Py_DECREF(mv);
  return arr;
}

static PyObject *dims_tuple(const int64_t *d, int n) {
  PyObject *t = PyTuple_New(n);
  for (int i = 0; i < n; ++i)
    PyTuple_SET_ITEM(t, i, PyLong_FromLongLong((long long)d[i]));
  return t;
}

static int64_t prod(const int64_t *d, int n) {
  int64_t p = 1;
  for (int i = 0; i < n; ++i) p *= d[i];
  return p;
}

static void sync_pull(void) {
  PyObject *m = compat_mod();
  if (!m) return;
  PyObject *d = PyObject_CallMethod(m, "get_globals", NULL);
  if (!d) { PyErr_Print(); return; }
  PyObject *v;
#define PULL_DBL(n)                                                         \
  if ((v = PyDict_GetItemString(d, #n))) { n = PyFloat_AsDouble(v); sh_##n = n; }
#define PULL_INT(n)                                                         \
  if ((v = PyDict_GetItemString(d, #n))) { n = (int)PyLong_AsLong(v); sh_##n = n; }
#define PULL_BOOL(n)                                                        \
  if ((v = PyDict_GetItemString(d, #n))) { n = PyObject_IsTrue(v); sh_##n = n; }
  GLOBAL_DBL(PULL_DBL)
  GLOBAL_INT(PULL_INT)
  GLOBAL_BOOL(PULL_BOOL)
  if ((v = PyDict_GetItemString(d, "Uloc")) && PySequence_Check(v)) {
    for (int i = 0; i < 5; ++i) {
      PyObject *x = PySequence_GetItem(v, i);
      if (x) { Uloc[i] = PyFloat_AsDouble(x); Py_DECREF(x); }
      sh_Uloc[i] = Uloc[i];
    }
  }
  Py_DECREF(d);
  if (PyErr_Occurred()) PyErr_Print();
}

static void sync_push(void) {
  PyObject *m = compat_mod();
  if (!m) return;
  PyObject *ch = PyDict_New();
#define PUSH_DBL(n)                                                         \
  if (n != sh_##n) { PyObject *o = PyFloat_FromDouble(n);                   \
    PyDict_SetItemString(ch, #n, o); Py_DECREF(o); }
#define PUSH_INT(n)                                                         \
  if (n != sh_##n) { PyObject *o = PyLong_FromLong(n);                      \
    PyDict_SetItemString(ch, #n, o); Py_DECREF(o); }
#define PUSH_BOOL(n)                                                        \
  if (n != sh_##n) { PyObject *o = PyBool_FromLong(n);                      \
    PyDict_SetItemString(ch, #n, o); Py_DECREF(o); }
  GLOBAL_DBL(PUSH_DBL)
  GLOBAL_INT(PUSH_INT)
  GLOBAL_BOOL(PUSH_BOOL)
  if (memcmp(Uloc, sh_Uloc, sizeof(Uloc)) != 0) {
    PyObject *u = PyList_New(5);
    for (int i = 0; i < 5; ++i)
      PyList_SET_ITEM(u, i, PyFloat_FromDouble(Uloc[i]));
    PyDict_SetItemString(ch, "Uloc", u);
    Py_DECREF(u);
  }
  if (PyDict_Size(ch) > 0) {
    PyObject *r = PyObject_CallMethod(m, "set_globals", "O", ch);
    if (!r) PyErr_Print();
    Py_XDECREF(r);
  }
  Py_DECREF(ch);
}

/* run compat.<fn>(*args); args is a NEW reference consumed here */
static PyObject *runv(const char *fn, PyObject *args) {
  if (edtpu_init()) {
    Py_XDECREF(args);
    fprintf(stderr, "edipack_tpu_torch compat: runtime init failed: %s\n",
            edtpu_last_error());
    return NULL;
  }
  sync_push();
  PyObject *m = compat_mod();
  PyObject *f = m ? PyObject_GetAttrString(m, fn) : NULL;
  PyObject *r = f ? PyObject_CallObject(f, args) : NULL;
  Py_XDECREF(f);
  Py_XDECREF(args);
  if (!r) PyErr_Print();
  sync_pull();
  return r;
}

static void run(const char *fn, PyObject *args) {
  PyObject *r = runv(fn, args);
  Py_XDECREF(r);
}

/* ======================================================================= */
/* input                                                                   */
/* ======================================================================= */

void read_input(char *instr) {
  if (edtpu_init()) return;

  run("read_input", Py_BuildValue("(s)", instr));
}

/* ======================================================================= */
/* Hloc                                                                    */
/* ======================================================================= */

static void set_hloc_n(const void *h, const void *ha, const int64_t *d,
                       int rank, int nlat) {
  if (edtpu_init()) return;
  int64_t n = prod(d, rank);
  PyObject *hw = wrap(h, n, "complex128", 0);
  PyObject *aw = ha ? wrap(ha, n, "complex128", 0) : Py_NewRef(Py_None);
  PyObject *dt = dims_tuple(d, rank);
  if (nlat > 0)
    run("set_hloc_lattice", Py_BuildValue("(NNNi)", hw, aw, dt, nlat));
  else
    run("set_hloc_single", Py_BuildValue("(NNN)", hw, aw, dt));
}

void ed_set_Hloc_single_N2(edc *h, edc *ha, int64_t *d) {
  set_hloc_n(h, ha, d, 2, 0);
}
void ed_set_Hloc_single_N4(edc *h, edc *ha, int64_t *d) {
  set_hloc_n(h, ha, d, 4, 0);
}
void ed_set_Hloc_lattice_N2(edc *h, edc *ha, int64_t *d, int Nlat) {
  set_hloc_n(h, ha, d, 2, Nlat);
}
void ed_set_Hloc_lattice_N3(edc *h, edc *ha, int64_t *d, int Nlat) {
  set_hloc_n(h, ha, d, 3, Nlat);
}
void ed_set_Hloc_lattice_N5(edc *h, edc *ha, int64_t *d, int Nlat) {
  set_hloc_n(h, ha, d, 5, Nlat);
}

/* ======================================================================= */
/* bath dimension / aux                                                    */
/* ======================================================================= */

int get_bath_dimension_direct(void) {
  if (edtpu_init()) return -1;

  PyObject *r = runv("bath_dimension_direct", NULL);
  long n = r ? PyLong_AsLong(r) : -1;
  Py_XDECREF(r);
  return (int)n;
}

int get_bath_dimension_symmetries(int Nsym) {
  if (edtpu_init()) return -1;

  PyObject *r =
      runv("bath_dimension_symmetries", Py_BuildValue("(i)", Nsym));
  long n = r ? PyLong_AsLong(r) : -1;
  Py_XDECREF(r);
  return (int)n;
}

void search_variable(double *var, double *ntmp, int64_t *converged) {
  if (edtpu_init()) return;

  PyObject *r =
      runv("search_variable", Py_BuildValue("(dd)", var[0], ntmp[0]));
  if (r && PyTuple_Check(r) && PyTuple_Size(r) == 2) {
    var[0] = PyFloat_AsDouble(PyTuple_GET_ITEM(r, 0));
    converged[0] = PyLong_AsLong(PyTuple_GET_ITEM(r, 1));
  }
  Py_XDECREF(r);
}

void ed_set_A_ph(double *A_new) {
  if (edtpu_init()) return;

  run("set_a_ph", Py_BuildValue("(N)", wrap(A_new, 1, "float64", 0)));
}

void ed_set_G_ph(edc *G_new) {
  if (edtpu_init()) return;

  run("set_g_ph", Py_BuildValue(
      "(N)", wrap(G_new, (Py_ssize_t)Norb * Norb, "complex128", 0)));
}

/* ======================================================================= */
/* replica/general bases                                                   */
/* ======================================================================= */

static void init_hbasis_n(const char *kind, const void *hv,
                          const int64_t *dh, int rh, const double *lam,
                          const int64_t *dl, int rl) {
  if (edtpu_init()) return;
  run("init_hbasis",
      Py_BuildValue("(sNNNN)", kind, wrap(hv, prod(dh, rh), "complex128", 0),
                    dims_tuple(dh, rh),
                    wrap(lam, prod(dl, rl), "float64", 0),
                    dims_tuple(dl, rl)));
}

void init_Hreplica_symmetries_d3(edc *h, int64_t *dh, double *l,
                                 int64_t *dl) {
  init_hbasis_n("replica", h, dh, 3, l, dl, 2);
}
void init_Hreplica_symmetries_d5(edc *h, int64_t *dh, double *l,
                                 int64_t *dl) {
  init_hbasis_n("replica", h, dh, 5, l, dl, 2);
}
void init_Hgeneral_symmetries_d3(edc *h, int64_t *dh, double *l,
                                 int64_t *dl) {
  init_hbasis_n("general", h, dh, 3, l, dl, 2);
}
void init_Hgeneral_symmetries_d5(edc *h, int64_t *dh, double *l,
                                 int64_t *dl) {
  init_hbasis_n("general", h, dh, 5, l, dl, 2);
}
void init_Hreplica_symmetries_lattice_d3(edc *h, int64_t *dh, double *l,
                                         int64_t *dl) {
  init_hbasis_n("replica", h, dh, 3, l, dl, 3);
}
void init_Hreplica_symmetries_lattice_d5(edc *h, int64_t *dh, double *l,
                                         int64_t *dl) {
  init_hbasis_n("replica", h, dh, 5, l, dl, 3);
}
void init_Hgeneral_symmetries_lattice_d3(edc *h, int64_t *dh, double *l,
                                         int64_t *dl) {
  init_hbasis_n("general", h, dh, 3, l, dl, 3);
}
void init_Hgeneral_symmetries_lattice_d5(edc *h, int64_t *dh, double *l,
                                         int64_t *dl) {
  init_hbasis_n("general", h, dh, 5, l, dl, 3);
}

/* ======================================================================= */
/* bath symmetry operations                                                */
/* ======================================================================= */

void break_symmetry_bath_site(double *bath, int64_t *db, double field,
                              double sgn, int sav) {
  if (edtpu_init()) return;

  run("bath_op_site",
      Py_BuildValue("(sNddO)", "ed_break_symmetry_bath",
                    wrap(bath, db[0], "float64", 1), field, sgn,
                    sav ? Py_True : Py_False));
}

void break_symmetry_bath_ineq(double *bath, int64_t *db, double field,
                              double *sgn, int sav) {
  if (edtpu_init()) return;

  run("bath_op_ineq",
      Py_BuildValue("(sNNdNO)", "ed_break_symmetry_bath",
                    wrap(bath, prod(db, 2), "float64", 1), dims_tuple(db, 2),
                    field, wrap(sgn, db[0], "float64", 0),
                    sav ? Py_True : Py_False));
}

void spin_symmetrize_bath_site(double *bath, int64_t *db, int sav) {
  if (edtpu_init()) return;

  run("bath_op_site",
      Py_BuildValue("(sNO)", "ed_spin_symmetrize_bath",
                    wrap(bath, db[0], "float64", 1),
                    sav ? Py_True : Py_False));
}
void spin_symmetrize_bath_ineq(double *bath, int64_t *db, int sav) {
  if (edtpu_init()) return;

  run("bath_op_ineq",
      Py_BuildValue("(sNNO)", "ed_spin_symmetrize_bath",
                    wrap(bath, prod(db, 2), "float64", 1), dims_tuple(db, 2),
                    sav ? Py_True : Py_False));
}

void orb_symmetrize_bath_site(double *bath, int64_t *db, int orb1, int orb2,
                              int sav) {
  if (edtpu_init()) return;

  run("bath_op_site",
      Py_BuildValue("(sNiiO)", "ed_orb_symmetrize_bath",
                    wrap(bath, db[0], "float64", 1), orb1, orb2,
                    sav ? Py_True : Py_False));
}
void orb_symmetrize_bath_ineq(double *bath, int64_t *db, int orb1, int orb2,
                              int sav) {
  if (edtpu_init()) return;

  run("bath_op_ineq",
      Py_BuildValue("(sNNiiO)", "ed_orb_symmetrize_bath",
                    wrap(bath, prod(db, 2), "float64", 1), dims_tuple(db, 2),
                    orb1, orb2, sav ? Py_True : Py_False));
}

void orb_equality_bath_site(double *bath, int64_t *db, int indx, int sav) {
  if (edtpu_init()) return;

  run("bath_op_site",
      Py_BuildValue("(sNiO)", "ed_orb_equality_bath",
                    wrap(bath, db[0], "float64", 1), indx,
                    sav ? Py_True : Py_False));
}
void orb_equality_bath_ineq(double *bath, int64_t *db, int indx, int sav) {
  if (edtpu_init()) return;

  run("bath_op_ineq",
      Py_BuildValue("(sNNiO)", "ed_orb_equality_bath",
                    wrap(bath, prod(db, 2), "float64", 1), dims_tuple(db, 2),
                    indx, sav ? Py_True : Py_False));
}

void ph_symmetrize_bath_site(double *bath, int64_t *db, int sav) {
  if (edtpu_init()) return;

  run("bath_op_site",
      Py_BuildValue("(sNO)", "ed_ph_symmetrize_bath",
                    wrap(bath, db[0], "float64", 1),
                    sav ? Py_True : Py_False));
}
void ph_symmetrize_bath_ineq(double *bath, int64_t *db, int sav) {
  if (edtpu_init()) return;

  run("bath_op_ineq",
      Py_BuildValue("(sNNO)", "ed_ph_symmetrize_bath",
                    wrap(bath, prod(db, 2), "float64", 1), dims_tuple(db, 2),
                    sav ? Py_True : Py_False));
}

void save_array_as_bath_site(double *bath, int64_t *db) {
  if (edtpu_init()) return;

  run("bath_op_site", Py_BuildValue("(sN)", "ed_save_array_as_bath",
                                    wrap(bath, db[0], "float64", 1)));
}
void save_array_as_bath_ineq(double *bath, int64_t *db) {
  if (edtpu_init()) return;

  run("bath_op_ineq",
      Py_BuildValue("(sNN)", "ed_save_array_as_bath",
                    wrap(bath, prod(db, 2), "float64", 1),
                    dims_tuple(db, 2)));
}

/* ======================================================================= */
/* chi^2 fits                                                              */
/* ======================================================================= */

static void fit_single_n(const void *g, const int64_t *dg, int rg,
                         const void *f, const int64_t *df, double *bath,
                         const int64_t *db, int ispin, int iorb) {
  if (edtpu_init()) return;
  PyObject *gw = wrap(g, prod(dg, rg), "complex128", 0);
  PyObject *gd = dims_tuple(dg, rg);
  PyObject *fw = f ? wrap(f, prod(df, rg), "complex128", 0)
                   : Py_NewRef(Py_None);
  PyObject *fd = f ? dims_tuple(df, rg) : Py_NewRef(Py_None);
  run("fit_single",
      Py_BuildValue("(NNNNNii)", gw, gd, fw, fd,
                    wrap(bath, db[0], "float64", 1), ispin, iorb));
}

void chi2_fitgf_single_normal_n3(edc *g, int64_t *dg, double *bath,
                                 int64_t *db, int ispin, int iorb,
                                 int fmpi) {
  (void)fmpi;
  fit_single_n(g, dg, 3, NULL, NULL, bath, db, ispin, iorb);
}
void chi2_fitgf_single_normal_n5(edc *g, int64_t *dg, double *bath,
                                 int64_t *db, int ispin, int iorb,
                                 int fmpi) {
  (void)fmpi;
  fit_single_n(g, dg, 5, NULL, NULL, bath, db, ispin, iorb);
}
void chi2_fitgf_single_superc_n3(edc *g, int64_t *dg, edc *f, int64_t *df,
                                 double *bath, int64_t *db, int ispin,
                                 int iorb, int fmpi) {
  (void)fmpi;
  fit_single_n(g, dg, 3, f, df, bath, db, ispin, iorb);
}
void chi2_fitgf_single_superc_n5(edc *g, int64_t *dg, edc *f, int64_t *df,
                                 double *bath, int64_t *db, int ispin,
                                 int iorb, int fmpi) {
  (void)fmpi;
  fit_single_n(g, dg, 5, f, df, bath, db, ispin, iorb);
}

static void fit_lattice_n(const void *g, const int64_t *dg, int rg,
                          const void *f, const int64_t *df, double *bath,
                          const int64_t *db, int ispin) {
  if (edtpu_init()) return;
  PyObject *gw = wrap(g, prod(dg, rg), "complex128", 0);
  PyObject *gd = dims_tuple(dg, rg);
  PyObject *fw = f ? wrap(f, prod(df, rg), "complex128", 0)
                   : Py_NewRef(Py_None);
  PyObject *fd = f ? dims_tuple(df, rg) : Py_NewRef(Py_None);
  run("fit_lattice",
      Py_BuildValue("(NNNNNNi)", gw, gd, fw, fd,
                    wrap(bath, prod(db, 2), "float64", 1), dims_tuple(db, 2),
                    ispin));
}

void chi2_fitgf_lattice_normal_n3(edc *g, int64_t *dg, double *bath,
                                  int64_t *db, int ispin) {
  fit_lattice_n(g, dg, 3, NULL, NULL, bath, db, ispin);
}
void chi2_fitgf_lattice_normal_n4(edc *g, int64_t *dg, double *bath,
                                  int64_t *db, int ispin) {
  fit_lattice_n(g, dg, 4, NULL, NULL, bath, db, ispin);
}
void chi2_fitgf_lattice_normal_n6(edc *g, int64_t *dg, double *bath,
                                  int64_t *db, int ispin) {
  fit_lattice_n(g, dg, 6, NULL, NULL, bath, db, ispin);
}
void chi2_fitgf_lattice_superc_n3(edc *g, int64_t *dg, edc *f, int64_t *df,
                                  double *bath, int64_t *db, int ispin) {
  fit_lattice_n(g, dg, 3, f, df, bath, db, ispin);
}
void chi2_fitgf_lattice_superc_n4(edc *g, int64_t *dg, edc *f, int64_t *df,
                                  double *bath, int64_t *db, int ispin) {
  fit_lattice_n(g, dg, 4, f, df, bath, db, ispin);
}
void chi2_fitgf_lattice_superc_n6(edc *g, int64_t *dg, edc *f, int64_t *df,
                                  double *bath, int64_t *db, int ispin) {
  fit_lattice_n(g, dg, 6, f, df, bath, db, ispin);
}

/* ======================================================================= */
/* static observables (real buffers, Fortran f90 ABI)                      */
/* ======================================================================= */

static void static_site_n(const char *name, double *out, Py_ssize_t n) {
  if (edtpu_init()) return;
  run("static_site",
      Py_BuildValue("(sN)", name, wrap(out, n, "float64", 1)));
}
static void static_lat_n(const char *name, double *out, Py_ssize_t n,
                         int nlat) {
  if (edtpu_init()) return;
  run("static_lattice",
      Py_BuildValue("(sNi)", name, wrap(out, n, "float64", 1), nlat));
}

void ed_get_dens_n1(double *s) { static_site_n("dens", s, Norb); }
void ed_get_dens_n2(double *s, int Nlat) {
  static_lat_n("dens", s, (Py_ssize_t)Nlat * Norb, Nlat);
}
void ed_get_mag_n2(double *s) { static_site_n("mag", s, 3 * (Py_ssize_t)Norb); }
void ed_get_mag_n3(double *s, int Nlat) {
  static_lat_n("mag", s, (Py_ssize_t)Nlat * 3 * Norb, Nlat);
}
void ed_get_docc_n1(double *s) { static_site_n("docc", s, Norb); }
void ed_get_docc_n2(double *s, int Nlat) {
  static_lat_n("docc", s, (Py_ssize_t)Nlat * Norb, Nlat);
}
void ed_get_phisc_n2(double *s) {
  static_site_n("phisc", s, (Py_ssize_t)Norb * Norb);
}
void ed_get_phisc_n3(double *s, int Nlat) {
  static_lat_n("phisc", s, (Py_ssize_t)Nlat * Norb * Norb, Nlat);
}
void ed_get_argsc_n2(double *s) {
  static_site_n("argsc", s, (Py_ssize_t)Norb * Norb);
}
void ed_get_argsc_n3(double *s, int Nlat) {
  static_lat_n("argsc", s, (Py_ssize_t)Nlat * Norb * Norb, Nlat);
}
void ed_get_eimp_n1(double *s) { static_site_n("eimp", s, 4); }
void ed_get_eimp_n2(double *s, int Nlat) {
  static_lat_n("eimp", s, (Py_ssize_t)Nlat * 4, Nlat);
}
void ed_get_phon(double *s) { static_site_n("phon", s, 3); }
void ed_get_ephon(double *s) { static_site_n("ephon", s, 2); }

/* ======================================================================= */
/* dynamical functions                                                     */
/* ======================================================================= */

static void gf_site_n(const char *which, void *out, Py_ssize_t n, int axis,
                      int typ, const void *zeta, int dz, int zflag,
                      int rank) {
  if (edtpu_init()) return;
  PyObject *zw = (zflag && zeta) ? wrap(zeta, dz, "complex128", 0)
                                 : Py_NewRef(Py_None);
  run("gf_site",
      Py_BuildValue("(sNiiNiii)", which, wrap(out, n, "complex128", 1), axis,
                    typ, zw, dz, zflag, rank));
}

static void gf_lat_n(const char *which, void *out, Py_ssize_t n, int nineq,
                     int axis, int typ, const void *zeta, int dz, int zflag,
                     int rank) {
  if (edtpu_init()) return;
  PyObject *zw = (zflag && zeta) ? wrap(zeta, dz, "complex128", 0)
                                 : Py_NewRef(Py_None);
  run("gf_lattice",
      Py_BuildValue("(sNiiiNiii)", which, wrap(out, n, "complex128", 1),
                    nineq, axis, typ, zw, dz, zflag, rank));
}

#define NSO ((Py_ssize_t)Nspin * Norb)

void get_sigma_site_n3(edc *s, int axis, int typ, edc *z, int dz, int zf) {
  gf_site_n("sigma", s, NSO * NSO * dz, axis, typ, z, dz, zf, 3);
}
void get_sigma_site_n5(edc *s, int axis, int typ, edc *z, int dz, int zf) {
  gf_site_n("sigma", s, NSO * NSO * dz, axis, typ, z, dz, zf, 5);
}
void get_gimp_site_n3(edc *s, int axis, int typ, edc *z, int dz, int zf) {
  gf_site_n("gimp", s, NSO * NSO * dz, axis, typ, z, dz, zf, 3);
}
void get_gimp_site_n5(edc *s, int axis, int typ, edc *z, int dz, int zf) {
  gf_site_n("gimp", s, NSO * NSO * dz, axis, typ, z, dz, zf, 5);
}
void get_sigma_lattice_n3(edc *s, int Nineq, int axis, int typ, edc *z,
                          int dz, int zf) {
  gf_lat_n("sigma", s, (Py_ssize_t)Nineq * NSO * Nineq * NSO * dz, Nineq,
           axis, typ, z, dz, zf, 3);
}
void get_sigma_lattice_n4(edc *s, int Nineq, int axis, int typ, edc *z,
                          int dz, int zf) {
  gf_lat_n("sigma", s, (Py_ssize_t)Nineq * NSO * NSO * dz, Nineq, axis, typ,
           z, dz, zf, 4);
}
void get_sigma_lattice_n6(edc *s, int Nineq, int axis, int typ, edc *z,
                          int dz, int zf) {
  gf_lat_n("sigma", s, (Py_ssize_t)Nineq * NSO * NSO * dz, Nineq, axis, typ,
           z, dz, zf, 6);
}
void get_gimp_lattice_n3(edc *s, int Nineq, int axis, int typ, edc *z,
                         int dz, int zf) {
  gf_lat_n("gimp", s, (Py_ssize_t)Nineq * NSO * Nineq * NSO * dz, Nineq,
           axis, typ, z, dz, zf, 3);
}
void get_gimp_lattice_n4(edc *s, int Nineq, int axis, int typ, edc *z,
                         int dz, int zf) {
  gf_lat_n("gimp", s, (Py_ssize_t)Nineq * NSO * NSO * dz, Nineq, axis, typ,
           z, dz, zf, 4);
}
void get_gimp_lattice_n6(edc *s, int Nineq, int axis, int typ, edc *z,
                         int dz, int zf) {
  gf_lat_n("gimp", s, (Py_ssize_t)Nineq * NSO * NSO * dz, Nineq, axis, typ,
           z, dz, zf, 6);
}
void get_dimp_site_n1(edc *d, int axis, edc *z, int dz, int zf) {
  gf_site_n("dimp", d, dz, axis, 0, z, dz, zf, 1);
}
void get_dimp_lattice_n2(edc *d, int Nineq, int axis, edc *z, int dz,
                         int zf) {
  gf_lat_n("dimp", d, (Py_ssize_t)Nineq * dz, Nineq, axis, 0, z, dz, zf, 2);
}

static void g0and_delta_n(const char *which, const void *w, const int64_t *dw,
                          double *bath, int nb, void *out, const int64_t *dout,
                          int rank, const char *axis, const char *typ) {
  if (edtpu_init()) return;
  run("g0and_delta",
      Py_BuildValue("(sNNNNss)", which, wrap(w, dw[0], "complex128", 0),
                    wrap(bath, nb, "float64", 0),
                    wrap(out, prod(dout, rank), "complex128", 1),
                    dims_tuple(dout, rank), axis ? axis : "m",
                    typ ? typ : "n"));
}

void get_g0and_n3(edc *w, int64_t *dw, double *bath, int nb, edc *out,
                  int64_t *dout, char *axis, char *typ) {
  g0and_delta_n("g0and", w, dw, bath, nb, out, dout, 3, axis, typ);
}
void get_g0and_n5(edc *w, int64_t *dw, double *bath, int nb, edc *out,
                  int64_t *dout, char *axis, char *typ) {
  g0and_delta_n("g0and", w, dw, bath, nb, out, dout, 5, axis, typ);
}
void get_delta_n3(edc *w, int64_t *dw, double *bath, int nb, edc *out,
                  int64_t *dout, char *axis, char *typ) {
  g0and_delta_n("delta", w, dw, bath, nb, out, dout, 3, axis, typ);
}
void get_delta_n5(edc *w, int64_t *dw, double *bath, int nb, edc *out,
                  int64_t *dout, char *axis, char *typ) {
  g0and_delta_n("delta", w, dw, bath, nb, out, dout, 5, axis, typ);
}

/* ======================================================================= */
/* susceptibilities                                                        */
/* ======================================================================= */

static void chi_n(const char *kind, void *out, const void *zeta, int dz,
                  int zflag, const char *axis, int nsites, int latflag) {
  if (edtpu_init()) return;
  PyObject *zw = (zflag && zeta) ? wrap(zeta, dz, "complex128", 0)
                                 : Py_NewRef(Py_None);
  run("chi_compat",
      Py_BuildValue("(sNNiisii)", kind,
                    wrap(out, (Py_ssize_t)nsites * Norb * Norb * dz,
                         "complex128", 1),
                    zw, dz, zflag, axis ? axis : "m", nsites, latflag));
}

void ed_get_spinchi(edc *s, edc *z, int dz, int zf, char *axis, int ns,
                    int lf) {
  chi_n("spin", s, z, dz, zf, axis, ns, lf);
}
void ed_get_denschi(edc *s, edc *z, int dz, int zf, char *axis, int ns,
                    int lf) {
  chi_n("dens", s, z, dz, zf, axis, ns, lf);
}
void ed_get_pairchi(edc *s, edc *z, int dz, int zf, char *axis, int ns,
                    int lf) {
  chi_n("pair", s, z, dz, zf, axis, ns, lf);
}
void ed_get_exctchi(edc *s, edc *z, int dz, int zf, char *axis, int ns,
                    int lf) {
  chi_n("exct", s, z, dz, zf, axis, ns, lf);
}

/* ======================================================================= */
/* density matrices                                                        */
/* ======================================================================= */

void ed_get_impurity_rdm(edc *rdm, int doprint) {
  if (edtpu_init()) return;

  Py_ssize_t dim = 1;
  for (int i = 0; i < Norb; ++i) dim *= 4;
  run("rdm_compat",
      Py_BuildValue("(Ni)", wrap(rdm, dim * dim, "complex128", 1), doprint));
}

void ed_get_denmat_n2(edc *dm, int64_t *dims, int doprint) {
  if (edtpu_init()) return;

  run("denmat_compat",
      Py_BuildValue("(NNi)", wrap(dm, prod(dims, 2), "complex128", 1),
                    dims_tuple(dims, 2), doprint));
}
void ed_get_denmat_n4(edc *dm, int64_t *dims, int doprint) {
  if (edtpu_init()) return;

  run("denmat_compat",
      Py_BuildValue("(NNi)", wrap(dm, prod(dims, 4), "complex128", 1),
                    dims_tuple(dims, 4), doprint));
}

/* ======================================================================= */
/* lifecycle                                                               */
/* ======================================================================= */

void init_solver_site(double *bath, int64_t *db) {
  if (edtpu_init()) return;

  run("init_solver_site",
      Py_BuildValue("(N)", wrap(bath, db[0], "float64", 1)));
}
void init_solver_site_nobath(void) { run("init_solver_site_nobath", NULL); }

void init_solver_ineq(double *bath, int64_t *db) {
  if (edtpu_init()) return;

  run("init_solver_ineq",
      Py_BuildValue("(NN)", wrap(bath, prod(db, 2), "float64", 1),
                    dims_tuple(db, 2)));
}
void init_solver_ineq_nobath(int Nlat) {
  if (edtpu_init()) return;

  run("init_solver_ineq_nobath", Py_BuildValue("(i)", Nlat));
}

void solve_site(double *bath, int64_t *db, int flag_gf, int flag_mpi) {
  if (edtpu_init()) return;

  (void)flag_mpi;
  run("solve_site", Py_BuildValue("(Ni)", wrap(bath, db[0], "float64", 0),
                                  flag_gf));
}
void solve_site_nobath(int flag_gf, int flag_mpi) {
  if (edtpu_init()) return;

  (void)flag_mpi;
  run("solve_site_nobath", Py_BuildValue("(i)", flag_gf));
}

void solve_ineq(double *bath, int64_t *db, int flag_gf, int mpi_lanc) {
  if (edtpu_init()) return;

  (void)mpi_lanc;
  run("solve_ineq",
      Py_BuildValue("(NNi)", wrap(bath, prod(db, 2), "float64", 0),
                    dims_tuple(db, 2), flag_gf));
}
void solve_ineq_nobath(int Nlat, int flag_gf, int mpi_lanc) {
  if (edtpu_init()) return;

  (void)mpi_lanc;
  run("solve_ineq_nobath", Py_BuildValue("(ii)", Nlat, flag_gf));
}

void finalize_solver(int Nineq) {
  if (edtpu_init()) return;

  run("finalize_solver", Py_BuildValue("(i)", Nineq));
}

/* ======================================================================= */
/* runtime umatrix                                                         */
/* ======================================================================= */

void reset_umatrix(void) { edtpu_reset_umatrix(); }

void add_twobody_operator(int o1, int s1, int o2, int s2, int o3, int s3,
                          int o4, int s4, double U) {
  edtpu_add_twobody_operator(o1, s1, o2, s2, o3, s3, o4, s4, U);
}
