/* Embedded-CPython implementation of the edipack_tpu C API over
 * edipack_tpu_torch (the same symbols as edipack_tpu's library, so a C
 * driver links either one unchanged).
 * The reference's C bindings are iso_c_binding wrappers over Fortran
 * globals (src/c_bindings/); here the "native runtime" is the PyTorch
 * engine, so the C ABI embeds the interpreter and drives the same
 * module-level ed_* API the Python user sees.
 *
 * The device: edtpu_init imports edipack_tpu_torch.capihelp first, which
 * checks EDIPACK_TPU_TORCH_DEVICE (cuda, cuda:N or cpu; default cuda)
 * against that list and fails for CUDA where it is absent; a failure makes
 * edtpu_init return -1 with the Python message in edtpu_last_error().
 * Every solver the library makes runs on that device. With WORLD_SIZE > 1
 * (and RANK, MASTER_ADDR, MASTER_PORT) in the environment, that import
 * also joins a torch.distributed group (capihelp.join_group); a group that
 * does not form fails edtpu_init the same way, and edtpu_finalize leaves
 * it (capihelp.finalize_library).
 *
 * EDTPU_PYTHON (set by capi/build.py) names the interpreter that built
 * the library; the embedded interpreter starts as that program, so it
 * finds the same installation (a virtual environment's packages too). */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <limits.h>
#include <stdio.h>
#include <string.h>

#include "edipack_tpu.h"

static PyObject *g_mod = NULL;        /* edipack_tpu_torch module */
static char g_err[1024] = "";

static PyObject *call_help(const char *fn, PyObject *args);

static void set_err_from_python(void) {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      snprintf(g_err, sizeof(g_err), "%s", PyUnicode_AsUTF8(s));
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

const char *edtpu_last_error(void) { return g_err; }

static int start_python(void) {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  PyStatus st = PyStatus_Ok();
#ifdef EDTPU_PYTHON
  st = PyConfig_SetBytesString(&config, &config.program_name, EDTPU_PYTHON);
#endif
  if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st)) {
    snprintf(g_err, sizeof(g_err), "Python start failed: %s",
             st.err_msg ? st.err_msg : "(no message)");
    return -1;
  }
  return 0;
}

int edtpu_init(void) {
  if (g_mod) return 0;
  if (!Py_IsInitialized() && start_python()) return -1;
  /* the library's device, checked at the import */
  PyObject *h = PyImport_ImportModule("edipack_tpu_torch.capihelp");
  if (!h) {
    set_err_from_python();
    return -1;
  }
  Py_DECREF(h);
  g_mod = PyImport_ImportModule("edipack_tpu_torch");
  if (!g_mod) {
    set_err_from_python();
    return -1;
  }
  return 0;
}

void edtpu_finalize(void) {
  if (g_mod) {
    PyObject *r = PyObject_CallMethod(g_mod, "ed_finalize_solver", NULL);
    Py_XDECREF(r);
    r = call_help("finalize_library", NULL);
    Py_XDECREF(r);
    Py_CLEAR(g_mod);
  }
}

static PyObject *call(const char *fn, PyObject *args) {
  PyObject *f = PyObject_GetAttrString(g_mod, fn);
  if (!f) {
    set_err_from_python();
    return NULL;
  }
  PyObject *r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  if (!r) set_err_from_python();
  return r;
}

int edtpu_read_input(const char *path) {
  if (edtpu_init()) return -1;
  PyObject *cfgmod = PyImport_ImportModule("edipack_tpu_torch.config");
  if (!cfgmod) { set_err_from_python(); return -1; }
  PyObject *r = PyObject_CallMethod(cfgmod, "ed_read_input", "s", path);
  Py_DECREF(cfgmod);
  if (!r) { set_err_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

static int set_option(const char *name, PyObject *value) {
  PyObject *cfgmod = PyImport_ImportModule("edipack_tpu_torch.config");
  if (!cfgmod) { set_err_from_python(); return -1; }
  PyObject *kw = PyDict_New();
  PyDict_SetItemString(kw, name, value);
  PyObject *f = PyObject_GetAttrString(cfgmod, "update_config");
  PyObject *empty = PyTuple_New(0);
  PyObject *r = f ? PyObject_Call(f, empty, kw) : NULL;
  Py_XDECREF(f);
  Py_DECREF(empty);
  Py_DECREF(kw);
  Py_DECREF(cfgmod);
  if (!r) { set_err_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

int edtpu_set_option_d(const char *name, double v) {
  if (edtpu_init()) return -1;
  PyObject *o = PyFloat_FromDouble(v);
  int rc = set_option(name, o);
  Py_DECREF(o);
  return rc;
}

int edtpu_set_option_i(const char *name, long v) {
  if (edtpu_init()) return -1;
  PyObject *o = PyLong_FromLong(v);
  int rc = set_option(name, o);
  Py_DECREF(o);
  return rc;
}

int edtpu_set_option_s(const char *name, const char *v) {
  if (edtpu_init()) return -1;
  PyObject *o = PyUnicode_FromString(v);
  int rc = set_option(name, o);
  Py_DECREF(o);
  return rc;
}

int edtpu_get_bath_dimension(void) {
  if (edtpu_init()) return -1;
  PyObject *r = call("ed_get_bath_dimension", NULL);
  if (!r) return -1;
  long n = PyLong_AsLong(r);
  Py_DECREF(r);
  return (int)n;
}

/* helper: copy a 1-D float ndarray into out */
static int copy_array(PyObject *arr, double *out, int nmax) {
  PyObject *lst = PyObject_CallMethod(arr, "tolist", NULL);
  if (!lst) { set_err_from_python(); return -1; }
  PyObject *flat = PySequence_Fast(lst, "expected sequence");
  Py_DECREF(lst);
  if (!flat) { set_err_from_python(); return -1; }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(flat);
  if (n > nmax) n = nmax;
  for (Py_ssize_t i = 0; i < n; ++i)
    out[i] = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(flat, i));
  Py_DECREF(flat);
  return (int)n;
}

int edtpu_init_solver(double *bath, int nb) {
  if (edtpu_init()) return -1;
  PyObject *r = call_help("init_solver", NULL);
  if (!r) return -1;
  int n = copy_array(r, bath, nb);
  Py_DECREF(r);
  return n < 0 ? -1 : 0;
}

int edtpu_set_hloc(const double *re, const double *im, int nso) {
  if (edtpu_init()) return -1;
  /* build a python list-of-lists complex matrix */
  PyObject *rows = PyList_New(nso);
  for (int i = 0; i < nso; ++i) {
    PyObject *row = PyList_New(nso);
    for (int j = 0; j < nso; ++j) {
      double vr = re ? re[i * nso + j] : 0.0;
      double vi = im ? im[i * nso + j] : 0.0;
      PyList_SET_ITEM(row, j, PyComplex_FromDoubles(vr, vi));
    }
    PyList_SET_ITEM(rows, i, row);
  }
  PyObject *args = PyTuple_Pack(1, rows);
  Py_DECREF(rows);
  PyObject *r = call("ed_set_hloc", args);
  Py_DECREF(args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

static PyObject *bath_to_pylist(const double *bath, int nb) {
  PyObject *lst = PyList_New(nb);
  for (int i = 0; i < nb; ++i)
    PyList_SET_ITEM(lst, i, PyFloat_FromDouble(bath[i]));
  return lst;
}

int edtpu_solve(const double *bath, int nb) {
  if (edtpu_init()) return -1;
  PyObject *lst = bath_to_pylist(bath, nb);
  PyObject *args = PyTuple_Pack(1, lst);
  Py_DECREF(lst);
  PyObject *r = call("ed_solve", args);
  Py_DECREF(args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

static int getter_1d(const char *fn, double *out, int nmax) {
  if (edtpu_init()) return -1;
  PyObject *r = call(fn, NULL);
  if (!r) return -1;
  PyObject *rav = PyObject_CallMethod(r, "ravel", NULL);
  Py_DECREF(r);
  if (!rav) { set_err_from_python(); return -1; }
  int n = copy_array(rav, out, nmax);
  Py_DECREF(rav);
  return n;
}

int edtpu_get_dens(double *out, int norb) { return getter_1d("ed_get_dens", out, norb) < 0 ? -1 : 0; }
int edtpu_get_docc(double *out, int norb) { return getter_1d("ed_get_docc", out, norb) < 0 ? -1 : 0; }
int edtpu_get_eimp(double *out4) { return getter_1d("ed_get_eimp", out4, 4) < 0 ? -1 : 0; }

int edtpu_get_evals(double *out, int *n, int nmax) {
  int got = getter_1d("ed_get_evals", out, nmax);
  if (got < 0) return -1;
  *n = got;
  return 0;
}

static int copy_complex_out(PyObject *arr, double *out, int nmax);

/* the whole default Matsubara grid (lmats is not read: out holds
 * 2*Nspin*Nspin*Norb*Norb*Lmats doubles) */
static int getter_gf(const char *which, double *out, int lmats) {
  if (edtpu_init()) return -1;
  PyObject *args = Py_BuildValue("(sss)", which, "m", "n");
  PyObject *r = call_help("get_gf", args);
  Py_DECREF(args);
  if (!r) return -1;
  int n = copy_complex_out(r, out, INT_MAX);
  Py_DECREF(r);
  (void)lmats;
  return n < 0 ? -1 : 0;
}

int edtpu_get_sigma_matsubara(double *out, int lmats) {
  return getter_gf("sigma", out, lmats);
}

int edtpu_get_gimp_matsubara(double *out, int lmats) {
  return getter_gf("gimp", out, lmats);
}

/* ---------------------------------------------------------------------- */
/* extended surface: statics, complex getters on default grids, replica
 * bases, runtime umatrix, ineq (lattice) variants — parity with the
 * reference header src/c_bindings/edipack_cbindings.h                      */
/* ---------------------------------------------------------------------- */

static PyObject *helper(void) {
  return PyImport_ImportModule("edipack_tpu_torch.capihelp");
}

static PyObject *call_help(const char *fn, PyObject *args) {
  PyObject *h = helper();
  if (!h) { set_err_from_python(); return NULL; }
  PyObject *f = PyObject_GetAttrString(h, fn);
  Py_DECREF(h);
  if (!f) { set_err_from_python(); return NULL; }
  PyObject *r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  if (!r) set_err_from_python();
  return r;
}

static PyObject *dbl_list(const double *p, Py_ssize_t n) {
  if (!p) Py_RETURN_NONE;
  PyObject *lst = PyList_New(n);
  for (Py_ssize_t i = 0; i < n; ++i)
    PyList_SET_ITEM(lst, i, PyFloat_FromDouble(p[i]));
  return lst;
}

/* copy a complex ndarray (any rank) into interleaved (re,im) out; returns
 * number of complex elements copied or -1 */
static int copy_complex_out(PyObject *arr, double *out, int nmax) {
  PyObject *flat = PyObject_CallMethod(arr, "ravel", NULL);
  if (!flat) { set_err_from_python(); return -1; }
  PyObject *re = PyObject_GetAttrString(flat, "real");
  PyObject *im = PyObject_GetAttrString(flat, "imag");
  Py_DECREF(flat);
  if (!re || !im) { Py_XDECREF(re); Py_XDECREF(im); return -1; }
  PyObject *relist = PyObject_CallMethod(re, "tolist", NULL);
  PyObject *imlist = PyObject_CallMethod(im, "tolist", NULL);
  Py_DECREF(re);
  Py_DECREF(im);
  if (!relist || !imlist) { Py_XDECREF(relist); Py_XDECREF(imlist); return -1; }
  Py_ssize_t n = PyList_Size(relist);
  if (n > nmax) n = nmax;
  for (Py_ssize_t i = 0; i < n; ++i) {
    out[2 * i] = PyFloat_AsDouble(PyList_GET_ITEM(relist, i));
    out[2 * i + 1] = PyFloat_AsDouble(PyList_GET_ITEM(imlist, i));
  }
  Py_DECREF(relist);
  Py_DECREF(imlist);
  return (int)n;
}

int edtpu_get_mag(const char *component, double *out, int norb) {
  if (edtpu_init()) return -1;
  PyObject *args = Py_BuildValue("(s)", component);
  PyObject *r = call("ed_get_mag", args);
  Py_DECREF(args);
  if (!r) return -1;
  PyObject *rav = PyObject_CallMethod(r, "ravel", NULL);
  Py_DECREF(r);
  if (!rav) { set_err_from_python(); return -1; }
  int n = copy_array(rav, out, norb);
  Py_DECREF(rav);
  return n < 0 ? -1 : 0;
}

int edtpu_get_doubles(double *out4) {
  return getter_1d("ed_get_doubles", out4, 4) < 0 ? -1 : 0;
}

int edtpu_get_phi(double *out, int n) {
  return getter_1d("ed_get_phi", out, n) < 0 ? -1 : 0;
}

int edtpu_get_argphi(double *out, int n) {
  return getter_1d("ed_get_argphi", out, n) < 0 ? -1 : 0;
}

int edtpu_get_exct(double *out, int n) {
  return getter_1d("ed_get_exct", out, n) < 0 ? -1 : 0;
}

static int gf_axis(const char *which, const char *axis, const char *typ,
                   double *out, int nmax) {
  if (edtpu_init()) return -1;
  PyObject *args = Py_BuildValue("(sss)", which, axis, typ);
  PyObject *r = call_help("get_gf", args);
  Py_DECREF(args);
  if (!r) return -1;
  int n = copy_complex_out(r, out, nmax);
  Py_DECREF(r);
  return n < 0 ? -1 : 0;
}

int edtpu_get_sigma_axis(const char *axis, const char *typ, double *out,
                         int nmax) {
  return gf_axis("sigma", axis, typ, out, nmax);
}

int edtpu_get_gimp_axis(const char *axis, const char *typ, double *out,
                        int nmax) {
  return gf_axis("gimp", axis, typ, out, nmax);
}

int edtpu_get_g0imp_axis(const char *axis, const char *typ, double *out,
                         int nmax) {
  return gf_axis("g0imp", axis, typ, out, nmax);
}

int edtpu_get_dimp_axis(const char *axis, double *out, int nmax) {
  return gf_axis("dimp", axis, "n", out, nmax);
}

int edtpu_get_chi(const char *kind, const char *axis, double *out, int nmax) {
  if (edtpu_init()) return -1;
  PyObject *args = Py_BuildValue("(ss)", kind, axis);
  PyObject *r = call_help("get_chi", args);
  Py_DECREF(args);
  if (!r) return -1;
  int n = copy_complex_out(r, out, nmax);
  Py_DECREF(r);
  return n < 0 ? -1 : 0;
}

int edtpu_get_rdm(double *out, int nmax) {
  if (edtpu_init()) return -1;
  PyObject *r = call_help("get_rdm_flat", NULL);
  if (!r) return -1;
  int n = copy_complex_out(r, out, nmax);
  Py_DECREF(r);
  return n < 0 ? -1 : n;
}

int edtpu_get_sp_dm(double *out, int nmax) {
  if (edtpu_init()) return -1;
  PyObject *r = call_help("get_sp_dm_flat", NULL);
  if (!r) return -1;
  int n = copy_complex_out(r, out, nmax);
  Py_DECREF(r);
  return n < 0 ? -1 : n;
}

int edtpu_add_twobody_operator(int oi, int si, int oj, int sj, int ok, int sk,
                               int ol, int sl, double u) {
  if (edtpu_init()) return -1;
  PyObject *args = Py_BuildValue("(iiiiiiiid)", oi, si, oj, sj, ok, sk, ol,
                                 sl, u);
  PyObject *r = call("ed_add_twobody_operator", args);
  Py_DECREF(args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

int edtpu_reset_umatrix(void) {
  if (edtpu_init()) return -1;
  PyObject *r = call("ed_reset_umatrix", NULL);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

static int set_basis(const char *fn, const double *re, const double *im,
                     int nsym, int nspin, int norb, const double *lam,
                     int nlam, int nbath) {
  if (edtpu_init()) return -1;
  Py_ssize_t nops = (Py_ssize_t)nsym * nspin * nspin * norb * norb;
  PyObject *rel = dbl_list(re, nops);
  PyObject *iml = dbl_list(im, nops);
  PyObject *laml = dbl_list(lam, nlam);
  PyObject *args = Py_BuildValue("(OOiiiOi)", rel, iml, nsym, nspin, norb,
                                 laml, nbath);
  Py_DECREF(rel);
  Py_DECREF(iml);
  Py_DECREF(laml);
  PyObject *r = call_help(fn, args);
  Py_DECREF(args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

int edtpu_set_hreplica(const double *re, const double *im, int nsym,
                       int nspin, int norb, const double *lam, int nlam,
                       int nbath) {
  return set_basis("set_hreplica_flat", re, im, nsym, nspin, norb, lam, nlam,
                   nbath);
}

int edtpu_set_hgeneral(const double *re, const double *im, int nsym,
                       int nspin, int norb, const double *lam, int nlam,
                       int nbath) {
  return set_basis("set_hgeneral_flat", re, im, nsym, nspin, norb, lam, nlam,
                   nbath);
}

int edtpu_solve_flag(const double *bath, int nb, int flag_gf) {
  if (edtpu_init()) return -1;
  PyObject *lst = bath_to_pylist(bath, nb);
  PyObject *args = Py_BuildValue("(OO)", lst, flag_gf ? Py_True : Py_False);
  Py_DECREF(lst);
  PyObject *r = call("ed_solve", args);
  Py_DECREF(args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

int edtpu_search_variable(double *var, double ntmp, int *converged) {
  if (edtpu_init()) return -1;
  PyObject *args = Py_BuildValue("(ddO)", *var, ntmp,
                                 *converged ? Py_True : Py_False);
  PyObject *r = call("ed_search_variable", args);
  Py_DECREF(args);
  if (!r) return -1;
  /* returns (var, converged) */
  PyObject *v0 = PyTuple_GetItem(r, 0);
  PyObject *v1 = PyTuple_GetItem(r, 1);
  if (v0) *var = PyFloat_AsDouble(v0);
  if (v1) *converged = PyObject_IsTrue(v1);
  Py_DECREF(r);
  return 0;
}

/* -- ineq (lattice) ----------------------------------------------------- */

int edtpu_ineq_init(int nineq) {
  if (edtpu_init()) return -1;
  PyObject *args = Py_BuildValue("(i)", nineq);
  PyObject *r = call_help("ineq_init", args);
  Py_DECREF(args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

int edtpu_ineq_init_solver(double *baths, int nineq, int nb) {
  /* output-only (reference ed_init_solver fills the user array; the input
   * buffer is uninitialized C memory and must not be adopted as a bath) */
  if (edtpu_init()) return -1;
  PyObject *args = Py_BuildValue("(Oi)", Py_None, 0);
  PyObject *r = call_help("ineq_init_solver", args);
  Py_DECREF(args);
  if (!r) return -1;
  PyObject *rav = PyObject_CallMethod(r, "ravel", NULL);
  Py_DECREF(r);
  if (!rav) { set_err_from_python(); return -1; }
  int n = copy_array(rav, baths, nineq * nb);
  Py_DECREF(rav);
  return n < 0 ? -1 : 0;
}

int edtpu_ineq_set_hloc(const double *re, const double *im, int nso,
                        int per_site, int nineq) {
  if (edtpu_init()) return -1;
  Py_ssize_t n = (Py_ssize_t)nso * nso * (per_site ? nineq : 1);
  PyObject *rel = dbl_list(re, n);
  PyObject *iml = dbl_list(im, n);
  PyObject *args = Py_BuildValue("(OOii)", rel, iml, nso, per_site);
  Py_DECREF(rel);
  Py_DECREF(iml);
  PyObject *r = call_help("ineq_set_hloc", args);
  Py_DECREF(args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

int edtpu_ineq_solve(const double *baths, int nineq, int nb, int flag_gf) {
  if (edtpu_init()) return -1;
  PyObject *bl = dbl_list(baths, (Py_ssize_t)nineq * nb);
  PyObject *args = Py_BuildValue("(Oii)", bl, nb, flag_gf);
  Py_DECREF(bl);
  PyObject *r = call_help("ineq_solve", args);
  Py_DECREF(args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

int edtpu_ineq_get(const char *name, double *out, int nmax) {
  if (edtpu_init()) return -1;
  PyObject *args = Py_BuildValue("(s)", name);
  PyObject *r = call_help("ineq_get", args);
  Py_DECREF(args);
  if (!r) return -1;
  PyObject *rav = PyObject_CallMethod(r, "ravel", NULL);
  Py_DECREF(r);
  if (!rav) { set_err_from_python(); return -1; }
  int n = copy_array(rav, out, nmax);
  Py_DECREF(rav);
  return n < 0 ? -1 : n;
}

int edtpu_ineq_get_gf(const char *name, double *out, int nmax) {
  if (edtpu_init()) return -1;
  PyObject *args = Py_BuildValue("(s)", name);
  PyObject *r = call_help("ineq_get", args);
  Py_DECREF(args);
  if (!r) return -1;
  int n = copy_complex_out(r, out, nmax);
  Py_DECREF(r);
  return n < 0 ? -1 : n;
}

int edtpu_ineq_fit_gf(const double *funcs, int l, double *baths, int nineq,
                      int nb, int ispin) {
  if (edtpu_init()) return -1;
  PyObject *h = helper();
  if (!h) { set_err_from_python(); return -1; }
  PyObject *cfgmod = PyImport_ImportModule("edipack_tpu_torch.config");
  PyObject *cfg = cfgmod ? PyObject_CallMethod(cfgmod, "get_config", NULL)
                         : NULL;
  PyObject *norb_o = cfg ? PyObject_GetAttrString(cfg, "norb") : NULL;
  long norb = norb_o ? PyLong_AsLong(norb_o) : 1;
  Py_XDECREF(norb_o);
  Py_XDECREF(cfg);
  Py_XDECREF(cfgmod);
  Py_DECREF(h);
  Py_ssize_t nf = 2L * nineq * norb * norb * l;
  PyObject *fl = dbl_list(funcs, nf);
  PyObject *bl = dbl_list(baths, (Py_ssize_t)nineq * nb);
  PyObject *args = Py_BuildValue("(OiOii)", fl, l, bl, nb, ispin);
  Py_DECREF(fl);
  Py_DECREF(bl);
  PyObject *r = call_help("ineq_fit_gf", args);
  Py_DECREF(args);
  if (!r) return -1;
  PyObject *rav = PyObject_CallMethod(r, "ravel", NULL);
  Py_DECREF(r);
  if (!rav) { set_err_from_python(); return -1; }
  int n = copy_array(rav, baths, nineq * nb);
  Py_DECREF(rav);
  return n < 0 ? -1 : 0;
}

int edtpu_chi2_fitgf(const double *func, int l, double *bath, int nb,
                     int ispin) {
  if (edtpu_init()) return -1;
  /* func: interleaved complex, shape inferred python-side as (..., l) —
   * passed as flat list; python reshapes to (norb,norb,l) via ed helper */
  PyObject *flat = PyList_New(2 * (Py_ssize_t)l);
  for (Py_ssize_t i = 0; i < 2 * (Py_ssize_t)l; ++i)
    PyList_SET_ITEM(flat, i, PyFloat_FromDouble(func[i]));
  PyObject *args = PyTuple_Pack(1, flat);
  Py_DECREF(flat);
  PyObject *cplx = call_help("complex_from_pairs", args);
  Py_DECREF(args);
  if (!cplx) return -1;
  PyObject *blist = bath_to_pylist(bath, nb);
  PyObject *r = PyObject_CallMethod(g_mod, "ed_chi2_fitgf", "OOi",
                                    cplx, blist, ispin);
  Py_DECREF(cplx);
  Py_DECREF(blist);
  if (!r) { set_err_from_python(); return -1; }
  PyObject *rav = PyObject_CallMethod(r, "ravel", NULL);
  Py_DECREF(r);
  if (!rav) { set_err_from_python(); return -1; }
  int n = copy_array(rav, bath, nb);
  Py_DECREF(rav);
  return n < 0 ? -1 : 0;
}

/* -- bath manipulation helpers (reference ED_BATH_USER) ----------------- */

static int bath_op(const char *fn, PyObject *args, double *bath, int nb) {
  PyObject *r = call(fn, args);
  Py_DECREF(args);
  if (!r) return -1;
  PyObject *rav = PyObject_CallMethod(r, "ravel", NULL);
  Py_DECREF(r);
  if (!rav) { set_err_from_python(); return -1; }
  int n = bath ? copy_array(rav, bath, nb) : 0;
  Py_DECREF(rav);
  return n < 0 ? -1 : 0;
}

int edtpu_break_symmetry_bath(double *bath, int nb, double field, double sgn,
                              int save) {
  if (edtpu_init()) return -1;
  PyObject *bl = bath_to_pylist(bath, nb);
  PyObject *args = Py_BuildValue("(Oddi)", bl, field, sgn, save);
  Py_DECREF(bl);
  return bath_op("ed_break_symmetry_bath", args, bath, nb);
}

int edtpu_spin_symmetrize_bath(double *bath, int nb, int save) {
  if (edtpu_init()) return -1;
  PyObject *bl = bath_to_pylist(bath, nb);
  PyObject *args = Py_BuildValue("(Oi)", bl, save);
  Py_DECREF(bl);
  return bath_op("ed_spin_symmetrize_bath", args, bath, nb);
}

int edtpu_orb_symmetrize_bath(double *bath, int nb, int orb1, int orb2,
                              int save) {
  if (edtpu_init()) return -1;
  PyObject *bl = bath_to_pylist(bath, nb);
  PyObject *args;
  if (orb1 > 0 && orb2 > 0)
    args = Py_BuildValue("(Oiii)", bl, orb1, orb2, save);
  else
    args = Py_BuildValue("(O)", bl);
  Py_DECREF(bl);
  return bath_op("ed_orb_symmetrize_bath", args, bath, nb);
}

int edtpu_orb_equality_bath(double *bath, int nb, int indx, int save) {
  if (edtpu_init()) return -1;
  PyObject *bl = bath_to_pylist(bath, nb);
  PyObject *args = Py_BuildValue("(Oii)", bl, indx, save);
  Py_DECREF(bl);
  return bath_op("ed_orb_equality_bath", args, bath, nb);
}

int edtpu_ph_symmetrize_bath(double *bath, int nb, int save) {
  if (edtpu_init()) return -1;
  PyObject *bl = bath_to_pylist(bath, nb);
  PyObject *args = Py_BuildValue("(Oi)", bl, save);
  Py_DECREF(bl);
  return bath_op("ed_ph_symmetrize_bath", args, bath, nb);
}

int edtpu_save_array_as_bath(const double *bath, int nb) {
  if (edtpu_init()) return -1;
  PyObject *bl = bath_to_pylist((double *)bath, nb);
  PyObject *args = Py_BuildValue("(O)", bl);
  Py_DECREF(bl);
  return bath_op("ed_save_array_as_bath", args, NULL, 0);
}

/* -- umatrix file IO ---------------------------------------------------- */

int edtpu_read_umatrix_file(const char *path) {
  if (edtpu_init()) return -1;
  PyObject *r = PyObject_CallMethod(g_mod, "ed_read_umatrix_file", "s", path);
  if (!r) { set_err_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

int edtpu_save_umatrix_file(const char *path) {
  if (edtpu_init()) return -1;
  PyObject *r = PyObject_CallMethod(g_mod, "ed_save_umatrix_file", "s", path);
  if (!r) { set_err_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

/* -- phonon couplings + scalar observables ------------------------------ */

int edtpu_set_g_ph(const double *g, int norb) {
  if (edtpu_init()) return -1;
  PyObject *lst = PyList_New((Py_ssize_t)norb * norb);
  for (Py_ssize_t i = 0; i < (Py_ssize_t)norb * norb; ++i)
    PyList_SET_ITEM(lst, i, PyFloat_FromDouble(g[i]));
  PyObject *r = PyObject_CallMethod(g_mod, "ed_set_g_ph", "O", lst);
  Py_DECREF(lst);
  if (!r) { set_err_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

int edtpu_set_a_ph(double a) {
  if (edtpu_init()) return -1;
  PyObject *r = PyObject_CallMethod(g_mod, "ed_set_a_ph", "d", a);
  if (!r) { set_err_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

int edtpu_get_phon(double *x, double *x2) {
  if (edtpu_init()) return -1;
  PyObject *r = PyObject_CallMethod(g_mod, "ed_get_phon", NULL);
  if (!r) { set_err_from_python(); return -1; }
  /* ed_get_phon returns (<b+b>, <X>, <X^2>); expose the displacement pair */
  double buf[3] = {0, 0, 0};
  PyObject *s = PySequence_Fast(r, "phon");
  Py_DECREF(r);
  if (!s) { set_err_from_python(); return -1; }
  for (int i = 0; i < 3 && i < PySequence_Fast_GET_SIZE(s); ++i)
    buf[i] = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(s, i));
  Py_DECREF(s);
  *x = buf[1]; *x2 = buf[2];
  return 0;
}

int edtpu_get_ephon(double *eph, double *eeph) {
  if (edtpu_init()) return -1;
  PyObject *r = PyObject_CallMethod(g_mod, "ed_get_ephon", NULL);
  if (!r) { set_err_from_python(); return -1; }
  double buf[2] = {0, 0};
  PyObject *s = PySequence_Fast(r, "ephon");
  Py_DECREF(r);
  if (!s) { set_err_from_python(); return -1; }
  for (int i = 0; i < 2 && i < PySequence_Fast_GET_SIZE(s); ++i)
    buf[i] = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(s, i));
  Py_DECREF(s);
  *eph = buf[0]; *eeph = buf[1];
  return 0;
}

int edtpu_get_imp_info(double *out2) {
  return getter_1d("ed_get_imp_info", out2, 2) < 0 ? -1 : 0;
}

int edtpu_get_neigen_sector(int *out, int *n, int nmax) {
  if (edtpu_init()) return -1;
  PyObject *r = PyObject_CallMethod(g_mod, "ed_get_neigen_sector", NULL);
  if (!r) { set_err_from_python(); return -1; }
  PyObject *s = PySequence_Fast(PyObject_CallMethod(r, "tolist", NULL), "nv");
  Py_DECREF(r);
  if (!s) { set_err_from_python(); return -1; }
  Py_ssize_t m = PySequence_Fast_GET_SIZE(s);
  if (m > nmax) m = nmax;
  for (Py_ssize_t i = 0; i < m; ++i)
    out[i] = (int)PyLong_AsLong(PySequence_Fast_GET_ITEM(s, i));
  Py_DECREF(s);
  *n = (int)m;
  return 0;
}

/* -- DMFT-loop convergence helper --------------------------------------- */

int edtpu_check_convergence(const double *func, int n, double *err,
                            int *converged) {
  if (edtpu_init()) return -1;
  PyObject *lst = PyList_New(n);
  for (Py_ssize_t i = 0; i < n; ++i)
    PyList_SET_ITEM(lst, i, PyFloat_FromDouble(func[i]));
  PyObject *r = PyObject_CallMethod(g_mod, "ed_check_convergence", "O", lst);
  Py_DECREF(lst);
  if (!r) { set_err_from_python(); return -1; }
  *err = PyFloat_AsDouble(PyTuple_GetItem(r, 0));
  *converged = PyObject_IsTrue(PyTuple_GetItem(r, 1));
  Py_DECREF(r);
  return 0;
}

int edtpu_reset_convergence(void) {
  if (edtpu_init()) return -1;
  PyObject *r = PyObject_CallMethod(g_mod, "ed_reset_convergence", NULL);
  if (!r) { set_err_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

/* -- per-site suffix ----------------------------------------------------- */

int edtpu_set_suffix(int isite) {
  if (edtpu_init()) return -1;
  PyObject *r = PyObject_CallMethod(g_mod, "ed_set_suffix", "i", isite);
  if (!r) { set_err_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

int edtpu_reset_suffix(void) {
  if (edtpu_init()) return -1;
  PyObject *r = PyObject_CallMethod(g_mod, "ed_reset_suffix", NULL);
  if (!r) { set_err_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}
