/* Hubbard model on the Bethe lattice — single-band DMFT loop in C, on
 * edipack_tpu_torch.
 *
 * The port's copy of examples/c/hm_bethe.c: the same physics and the same
 * calls of the drop-in reference C ABI, here exported by
 * libedipack_tpu_torch_c.so (edipack_compat.h reproduces
 * src/c_bindings/edipack_cbindings.h).
 *
 * The infinite-coordination Bethe lattice closes the DMFT
 * self-consistency in one line: Delta(iw) = (D/2)^2 G_imp(iw).  Each
 * iteration solves the impurity, rebuilds the hybridization from G_imp,
 * chi^2-fits the bath to it, mixes, and checks convergence.
 *
 *   hm_bethe [NLOOP]
 *
 * NLOOP caps the loop (else HM_BETHE_NLOOP, else 30); the last loop fits
 * no bath, since nothing would use it. The device comes from
 * EDIPACK_TPU_TORCH_DEVICE (cuda, the default; cuda:N; cpu). It prints a
 * line per loop and writes impG_iw.ed (w_n, Im G, Re G) in the working
 * directory.
 *
 * Build (the library too, if needed) and run:
 *   python -m edipack_tpu_torch.examples.c.build   # prints the program
 *   EDIPACK_TPU_TORCH_DEVICE=cpu PYTHONPATH=<repo> <program> 2
 */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "edipack_tpu.h"
#include "edipack_compat.h"

#define LMATS 512
#define NBATH_ 5
#define WBAND 1.0
#define WMIX 0.5
#define NLOOP_DEFAULT 30
#define DMFT_ERR 1e-5

static double creal_of(edc *z) { double r; memcpy(&r, z, 8); return r; }
static double cimag_of(edc *z) {
  double i; memcpy(&i, ((char *)z) + 8, 8); return i;
}
static void set_c(edc *z, double re, double im) {
  memcpy(z, &re, 8); memcpy(((char *)z) + 8, &im, 8);
}

static int loop_cap(int argc, char **argv) {
  const char *s = argc > 1 ? argv[1] : getenv("HM_BETHE_NLOOP");
  int n = s ? atoi(s) : NLOOP_DEFAULT;
  return n > 0 ? n : NLOOP_DEFAULT;
}

int main(int argc, char **argv) {
  int nloop = loop_cap(argc, argv);
  if (edtpu_init()) {
    printf("ERR %s\n", edtpu_last_error());
    return 1;
  }
  edtpu_set_option_i("ed_verbose", 0);
  edtpu_set_option_s("cg_scheme", "delta");
  edtpu_set_option_i("cg_niter", 600);

  /* reference drivers write the bind(c) module globals directly */
  Norb = 1; Nbath = NBATH_; Nspin = 1;
  beta = 100.0; Lmats = LMATS; Lfit = LMATS;
  Uloc[0] = 2.0; xmu = 0.0;

  int nb = get_bath_dimension_direct();
  double *bath = calloc(nb, sizeof(double));
  int64_t db[1] = {nb};
  init_solver_site(bath, db);

  edc hloc[1]; memset(hloc, 0, sizeof(hloc));
  int64_t dh[2] = {1, 1};
  ed_set_Hloc_single_N2(hloc, hloc, dh);

  edc *g = malloc(LMATS * sizeof(edc));
  edc *delta = malloc(LMATS * sizeof(edc));
  edc *delta_prev = calloc(LMATS, sizeof(edc));
  int64_t dg[5] = {1, 1, 1, 1, LMATS};
  double dens[1];

  for (int loop = 1; loop <= nloop; ++loop) {
    solve_site(bath, db, 1, 0);
    get_gimp_site_n5(g, 0, 0, NULL, LMATS, 0); /* Matsubara, default grid */

    /* Bethe self-consistency + linear mixing */
    double num = 0.0, den = 0.0;
    for (int i = 0; i < LMATS; ++i) {
      double re = 0.25 * WBAND * WBAND * creal_of(&g[i]);
      double im = 0.25 * WBAND * WBAND * cimag_of(&g[i]);
      if (loop > 1) {
        re = WMIX * re + (1.0 - WMIX) * creal_of(&delta_prev[i]);
        im = WMIX * im + (1.0 - WMIX) * cimag_of(&delta_prev[i]);
      }
      set_c(&delta[i], re, im);
      num += fabs(re - creal_of(&delta_prev[i]))
           + fabs(im - cimag_of(&delta_prev[i]));
      den += fabs(re) + fabs(im);
    }
    double err = (loop == 1) ? 1.0 : num / (den > 1e-15 ? den : 1e-15);
    memcpy(delta_prev, delta, LMATS * sizeof(edc));

    ed_get_dens_n1(dens);
    printf("loop %3d  err %.3e  dens %.6f\n", loop, err, dens[0]);
    fflush(stdout);
    if (err < DMFT_ERR || loop == nloop) break;

    chi2_fitgf_single_normal_n5(delta, dg, bath, db, 1, 0, 0);
  }

  /* reference-style text output */
  FILE *f = fopen("impG_iw.ed", "w");
  for (int i = 0; i < LMATS; ++i) {
    double wn = (2 * i + 1) * M_PI / beta;
    fprintf(f, "%.9e %.9e %.9e\n", wn, cimag_of(&g[i]), creal_of(&g[i]));
  }
  fclose(f);
  printf("done: dens=%.6f; wrote impG_iw.ed\n", dens[0]);

  finalize_solver(0);
  edtpu_finalize();
  free(bath); free(g); free(delta); free(delta_prev);
  return 0;
}
