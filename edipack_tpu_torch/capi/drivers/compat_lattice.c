/* Inequivalent sites through the reference EDIpack C-binding names
 * (edipack_compat.h, the edipack2ineq part), as a real-space DMFT driver
 * written for the reference calls them.
 *
 *   compat_lattice INPUT_FILE NLAT HSTAG
 *
 * Reads the configuration from INPUT_FILE (read_input, which sets the
 * exported globals Norb, Nspin, Lmats, ...), gives site n (from 0) the
 * Hloc (2n - NLAT + 1) / 2 * HSTAG on every orbital (ed_set_Hloc_lattice_N3),
 * starts the sites with their default baths (init_solver_ineq), solves
 * them (solve_ineq), and prints one line per quantity, "NAME count v1 v2
 * ...": DENS, DOCC, EIMP (Fortran order (Nlat, ...)) and G (the Matsubara
 * G, (Nlat,Nspin,Nspin,Norb,Norb,Lmats) Fortran order, interleaved re/im).
 * Python errors go to stderr (the reference's functions return nothing).
 * The device comes from EDIPACK_TPU_TORCH_DEVICE. */
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
  if (argc < 4) {
    fprintf(stderr, "usage: %s INPUT_FILE NLAT HSTAG\n", argv[0]);
    return 2;
  }
  int nlat = atoi(argv[2]);
  double hstag = atof(argv[3]);
  if (edtpu_init()) {
    printf("ERR %s\n", edtpu_last_error());
    return 1;
  }
  read_input(argv[1]);
  int nb = get_bath_dimension_direct();
  int nso = Nspin * Norb, ng = nlat * nso * nso * Lmats;
  edc *h = calloc((size_t)nlat * nso * nso, sizeof(edc));
  for (int s = 0; s < nlat; ++s)      /* (Nlat, Nso, Nso) Fortran order */
    for (int a = 0; a < nso; ++a)
      h[s + nlat * (a + nso * a)].re = 0.5 * (2 * s - nlat + 1) * hstag;
  double *bath = malloc(sizeof(double) * nlat * nb);
  double *buf = malloc(sizeof(double) * (4 * nlat * Norb + 64));
  edc *g = malloc(sizeof(edc) * ng);
  int64_t dh[3] = {nlat, nso, nso}, db[2] = {nlat, nb};
  ed_set_Hloc_lattice_N3(h, NULL, dh, nlat);
  init_solver_ineq(bath, db);
  solve_ineq(bath, db, 1, 0);
  ed_get_dens_n2(buf, nlat);
  put("DENS", buf, nlat * Norb);
  ed_get_docc_n2(buf, nlat);
  put("DOCC", buf, nlat * Norb);
  ed_get_eimp_n2(buf, nlat);
  put("EIMP", buf, nlat * 4);
  get_gimp_lattice_n6(g, nlat, 0, 0, NULL, Lmats, 0);
  put("G", (const double *)g, 2 * ng);
  finalize_solver(nlat);
  free(h);
  free(bath);
  free(buf);
  free(g);
  return 0;
}
