/* Inequivalent sites through the edtpu_ineq_* API (edipack_tpu.h).
 *
 *   edtpu_lattice INPUT_FILE NSPIN NORB LMATS NLAT HSTAG
 *
 * Reads the configuration from INPUT_FILE (edtpu_read_input; NSPIN, NORB
 * and LMATS are its values, which size the buffers), starts NLAT sites
 * with their default baths, gives site n (from 0) the Hloc
 * (2n - NLAT + 1) / 2 * HSTAG on every orbital, solves them, and prints
 * one line per quantity, "NAME count v1 v2 ...": DENS, DOCC, EIMP (C order
 * [Nlat, ...]) and G ([Nlat,Nspin,Nspin,Norb,Norb,L] on the default
 * Matsubara grid, interleaved re/im). The device comes from
 * EDIPACK_TPU_TORCH_DEVICE. Exits 1 on the first error, printing "ERR
 * message". */
#include <stdio.h>
#include <stdlib.h>

#include "edipack_tpu.h"

static int fail(void) {
  printf("ERR %s\n", edtpu_last_error());
  return 1;
}

static void put(const char *name, const double *v, int n) {
  printf("%s %d", name, n);
  for (int i = 0; i < n; ++i) printf(" %.17g", v[i]);
  printf("\n");
}

int main(int argc, char **argv) {
  if (argc < 7) {
    fprintf(stderr, "usage: %s INPUT_FILE NSPIN NORB LMATS NLAT HSTAG\n",
            argv[0]);
    return 2;
  }
  int nspin = atoi(argv[2]), norb = atoi(argv[3]), lmats = atoi(argv[4]);
  int nlat = atoi(argv[5]);
  double hstag = atof(argv[6]);
  int nso = nspin * norb, ng = nlat * nso * nso * lmats;
  if (edtpu_init() || edtpu_read_input(argv[1])) return fail();
  int nb = edtpu_get_bath_dimension();
  if (nb < 0 || edtpu_ineq_init(nlat)) return fail();
  double *baths = malloc(sizeof(double) * nlat * nb);
  double *hre = calloc((size_t)nlat * nso * nso, sizeof(double));
  double *buf = malloc(sizeof(double) * (2 * ng + 4 * nlat + 64));
  for (int s = 0; s < nlat; ++s)
    for (int a = 0; a < nso; ++a)
      hre[(s * nso + a) * nso + a] = 0.5 * (2 * s - nlat + 1) * hstag;
  if (edtpu_ineq_init_solver(baths, nlat, nb)) return fail();
  if (edtpu_ineq_set_hloc(hre, NULL, nso, 1, nlat)) return fail();
  if (edtpu_ineq_solve(baths, nlat, nb, 1)) return fail();
  const char *names[3] = {"dens", "docc", "eimp"};
  const char *tags[3] = {"DENS", "DOCC", "EIMP"};
  for (int k = 0; k < 3; ++k) {
    int n = edtpu_ineq_get(names[k], buf, 4 * nlat + 64);
    if (n < 0) return fail();
    put(tags[k], buf, n);
  }
  int n = edtpu_ineq_get_gf("gimp", buf, ng);
  if (n < 0) return fail();
  put("G", buf, 2 * n);
  free(baths);
  free(hre);
  free(buf);
  edtpu_finalize();
  return 0;
}
