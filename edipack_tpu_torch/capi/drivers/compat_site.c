/* One impurity through the reference EDIpack C-binding names
 * (edipack_compat.h), as a driver written for the reference calls them.
 *
 *   compat_site INPUT_FILE
 *
 * Reads the configuration from INPUT_FILE (read_input, which sets the
 * exported globals Norb, Nspin, Lmats, ...), solves one site with a zero
 * Hloc and the default bath, fits the bath to the solve's Matsubara G
 * (chi2_fitgf_single_normal_n5), and prints one line per quantity, "NAME
 * count v1 v2 ...": NB, DENS, DOCC, EIMP, G (the Matsubara G, interleaved
 * re/im, Fortran order (Nspin,Nspin,Norb,Norb,Lmats)), FIT (the fitted
 * bath). Python errors go to stderr (the reference's functions return
 * nothing). The device comes from EDIPACK_TPU_TORCH_DEVICE. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "edipack_tpu.h"
#include "edipack_compat.h"

static void put(const char *name, const double *v, int n) {
  printf("%s %d", name, n);
  for (int i = 0; i < n; ++i) printf(" %.17g", v[i]);
  printf("\n");
}

int main(int argc, char **argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s INPUT_FILE\n", argv[0]);
    return 2;
  }
  if (edtpu_init()) {
    printf("ERR %s\n", edtpu_last_error());
    return 1;
  }
  read_input(argv[1]);
  int nb = get_bath_dimension_direct();
  double nbd = nb;
  put("NB", &nbd, 1);
  int nso = Nspin * Norb, ng = nso * nso * Lmats;
  double *bath = malloc(sizeof(double) * nb);
  edc *h = calloc(nso * nso, sizeof(edc));
  edc *g = malloc(sizeof(edc) * ng);
  double buf[64];
  int64_t db[1] = {nb}, dh[2] = {nso, nso};
  int64_t dg[5] = {Nspin, Nspin, Norb, Norb, Lmats};
  init_solver_site(bath, db);
  ed_set_Hloc_single_N2(h, NULL, dh);
  solve_site(bath, db, 1, 0);
  ed_get_dens_n1(buf);
  put("DENS", buf, Norb);
  ed_get_docc_n1(buf);
  put("DOCC", buf, Norb);
  ed_get_eimp_n1(buf);
  put("EIMP", buf, 4);
  get_gimp_site_n5(g, 0, 0, NULL, Lmats, 0);
  put("G", (const double *)g, 2 * ng);
  chi2_fitgf_single_normal_n5(g, dg, bath, db, 1, 0, 0);
  put("FIT", bath, nb);
  finalize_solver(0);
  free(bath);
  free(h);
  free(g);
  return 0;
}
