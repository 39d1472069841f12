/* Oracle driver for parity testing of the JAX phylogenetic engine.
 *
 * Reads a small line-based script on stdin that configures a libpll-2
 * partition (the reference implementation, linked from /root/reference),
 * runs likelihood/derivative computations, and prints results at full
 * precision (%.17g).  The Python test-suite generates scripts, runs this
 * binary, and stores the outputs as golden fixtures.
 *
 * This file is NOT part of the framework; it exists only to extract golden
 * numbers from the reference implementation.
 *
 * Script commands (one per line, '#' comments):
 *   create tips clv_buffers states sites rate_matrices prob_matrices \
 *          rate_cats scale_buffers attrib
 *   map nt|aa|bin|gt10|gt16|odd5            (tip state map for 'tip' cmds)
 *   freqs <index> f0 f1 ...
 *   subst <index> s0 s1 ...
 *   rates r0 r1 ...
 *   rate_weights w0 w1 ...
 *   gamma <alpha> <ncats> <mean|median>     (compute+set category rates)
 *   pinv <index> <value>
 *   tip <index> <sequence>
 *   tipclv <index> v0 v1 ... (sites*rate_cats*states values)
 *   pattern_weights w0 w1 ...
 *   update_invariant_sites
 *   pmatrices <count> <params_indices...(rate_cats)> then <count> lines:
 *       <matrix_index> <branch_length>
 *   op parent c1 c2 m1 m2 pscaler c1scaler c2scaler   (indices, -1 = none)
 *   partials                                (run queued ops)
 *   root <clv_index> <scaler_index>         (print root logL + persite)
 *   edge <pclv> <pscaler> <cclv> <cscaler> <pmatrix_index>
 *   sumtable <pclv> <pscaler> <cclv> <cscaler>  (parent=inner,child=inner)
 *   sumtable_ti <pclv> <pscaler> <tip_index>
 *   derivatives <branch_length>             (after sumtable; prints d1 d2)
 *   print_pmatrix <index>
 *   print_clv <index>
 *   print_rates                             (print category rates)
 *   print_scaler <index>
 *   asc_weights w0 ... w{states-1}          (set asc-bias state weights)
 *   pars_create tips states sites score_buffers ancestral_buffers
 *       then one line: states*states score-matrix doubles
 *   pars_tip <index> <sequence>             (uses current map)
 *   pars_op p c1 c2                         (queue Sankoff build op)
 *   pars_build                              (run ops; prints pars_build_score)
 *   pars_score <index>                      (prints pars_score)
 *   pars_recop node_s node_a parent_s parent_a   (queue reconstruct op)
 *   pars_reconstruct                        (run; prints pars_anc per op)
 *   fastpars_init                           (Fitch init from partition;
 *                                            prints fastpars_const/informative)
 *   fastpars_op p c1 c2 | fastpars_update   (queue / run vector updates)
 *   fastpars_edge i j | fastpars_root i     (print scores)
 */
#include "pll.h"
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAXOPS 4096
#define LINE 1048576

static pll_partition_t *part = NULL;
static const pll_state_t *cur_map = NULL;
static pll_operation_t ops[MAXOPS];
static unsigned int nops = 0;
static unsigned int params_indices[64];
static double sumtable_buf_storage = 0;
static double *sumtable = NULL;
static unsigned int sum_pscaler, sum_cscaler;

static pll_state_t odd5_map[256];

static pll_parsimony_t *spars = NULL;       /* Sankoff instance */
static pll_parsimony_t *fpars = NULL;       /* Fitch instance */
static pll_utree_t *stepwise_tree = NULL;   /* last stepwise result */

/* --- minimal newick -> unode graph (test scaffolding for ascii_utree;
 *     the reference's own parser is bison/flex, unbuildable here) ------ */

static pll_unode_t *ascii_alloc_node(void)
{
  pll_unode_t *n = (pll_unode_t *)calloc(1, sizeof(pll_unode_t));
  return n;
}

static char *ascii_read_label(const char **s)
{
  const char *p = *s;
  while (**s && !strchr("():,;", **s)) (*s)++;
  if (*s == p) return NULL;
  char *lab = (char *)malloc((size_t)(*s - p) + 1);
  memcpy(lab, p, (size_t)(*s - p));
  lab[*s - p] = 0;
  return lab;
}

static double ascii_read_length(const char **s)
{
  if (**s != ':') return 0.0;
  (*s)++;
  char *end;
  double v = strtod(*s, &end);
  *s = end;
  return v;
}

/* returns the child-side half-node (caller links ->back) */
static pll_unode_t *ascii_subtree(const char **s)
{
  pll_unode_t *n;
  if (**s == '(')
  {
    (*s)++;
    pll_unode_t *kids[64];
    int k = 0;
    kids[k++] = ascii_subtree(s);
    while (**s == ',') { (*s)++; kids[k++] = ascii_subtree(s); }
    if (**s == ')') (*s)++;
    char *label = ascii_read_label(s);
    pll_unode_t *ring[65];
    int i;
    for (i = 0; i < k + 1; ++i) ring[i] = ascii_alloc_node();
    for (i = 0; i < k + 1; ++i)
      ring[i]->next = ring[(i + 1) % (k + 1)];
    /* label only on the rendered (up) half: graph_destroy frees labels
       per half-node, so sharing one pointer would double-free */
    ring[0]->label = label;
    for (i = 0; i < k; ++i)
    {
      ring[i + 1]->back = kids[i];
      kids[i]->back = ring[i + 1];
      ring[i + 1]->length = kids[i]->length;
    }
    n = ring[0];
  }
  else
  {
    n = ascii_alloc_node();
    n->label = ascii_read_label(s);
  }
  n->length = ascii_read_length(s);
  return n;
}

/* rooted variant: pll_rnode_t graph for pll_rtree_show_ascii */
static pll_rnode_t *ascii_rsubtree(const char **s)
{
  pll_rnode_t *n = (pll_rnode_t *)calloc(1, sizeof(pll_rnode_t));
  if (**s == '(')
  {
    (*s)++;
    n->left = ascii_rsubtree(s);
    if (**s == ',') (*s)++;
    n->right = ascii_rsubtree(s);
    if (**s == ')') (*s)++;
    n->left->parent = n->right->parent = n;
  }
  n->label = ascii_read_label(s);
  n->length = ascii_read_length(s);
  return n;
}

static void ascii_rdestroy(pll_rnode_t *n)
{
  if (!n) return;
  ascii_rdestroy(n->left);
  ascii_rdestroy(n->right);
  free(n->label);
  free(n);
}

static pll_unode_t *ascii_parse_newick(const char *s)
{
  if (*s != '(') return NULL;
  s++;
  pll_unode_t *kids[64];
  int k = 0;
  kids[k++] = ascii_subtree(&s);
  while (*s == ',') { s++; kids[k++] = ascii_subtree(&s); }
  if (*s == ')') s++;
  char *label = ascii_read_label(&s);
  ascii_read_length(&s);
  pll_unode_t *ring[64];
  int i;
  for (i = 0; i < k; ++i) ring[i] = ascii_alloc_node();
  ring[0]->label = label;
  for (i = 0; i < k; ++i)
  {
    ring[i]->next = ring[(i + 1) % k];
    ring[i]->back = kids[i];
    kids[i]->back = ring[i];
    ring[i]->length = kids[i]->length;
  }
  return ring[0];
}
static pll_pars_buildop_t parsops[MAXOPS];
static unsigned int nparsops = 0;
static pll_pars_recop_t recops[MAXOPS];
static unsigned int nrecops = 0;

static void die(const char *msg)
{
  fprintf(stderr, "oracle error: %s (pll_errmsg: %s)\n", msg, pll_errmsg);
  exit(1);
}

static void init_odd5(void)
{
  /* 5-state custom map used by the reference tests for odd state counts:
     digits 0-4 map to single states, '-' and '?' to gap (all bits). */
  memset(odd5_map, 0, sizeof(odd5_map));
  odd5_map['0'] = 1; odd5_map['1'] = 2; odd5_map['2'] = 4;
  odd5_map['3'] = 8; odd5_map['4'] = 16;
  odd5_map['-'] = 31; odd5_map['?'] = 31;
}

static double *read_doubles(char *s, unsigned int n)
{
  double *v = (double*)malloc(n * sizeof(double));
  unsigned int i;
  char *tok = strtok(s, " \t\n");
  for (i = 0; i < n; ++i)
  {
    if (!tok) die("not enough numbers");
    v[i] = atof(tok);
    tok = strtok(NULL, " \t\n");
  }
  return v;
}

int main(void)
{
  char *line = (char*)malloc(LINE);
  char cmd[64];
  init_odd5();
  cur_map = pll_map_nt;

  while (fgets(line, LINE, stdin))
  {
    if (line[0] == '#' || line[0] == '\n') continue;
    if (sscanf(line, "%63s", cmd) != 1) continue;
    char *rest = line + strlen(cmd);

    if (!strcmp(cmd, "create"))
    {
      unsigned int tips, clvs, states, sites, rm, pm, rc, sb, attrib;
      if (sscanf(rest, "%u %u %u %u %u %u %u %u %u",
                 &tips, &clvs, &states, &sites, &rm, &pm, &rc, &sb,
                 &attrib) != 9) die("create args");
      part = pll_partition_create(tips, clvs, states, sites, rm, pm, rc, sb,
                                  attrib);
      if (!part) die("partition_create");
    }
    else if (!strcmp(cmd, "map"))
    {
      char name[32];
      sscanf(rest, "%31s", name);
      if (!strcmp(name, "nt")) cur_map = pll_map_nt;
      else if (!strcmp(name, "aa")) cur_map = pll_map_aa;
      else if (!strcmp(name, "bin")) cur_map = pll_map_bin;
      else if (!strcmp(name, "gt10")) cur_map = pll_map_gt10;
      else if (!strcmp(name, "gt16")) cur_map = pll_map_gt16;
      else if (!strcmp(name, "odd5")) cur_map = odd5_map;
      else die("unknown map");
    }
    else if (!strcmp(cmd, "freqs"))
    {
      unsigned int idx; int off;
      sscanf(rest, "%u%n", &idx, &off);
      double *v = read_doubles(rest + off, part->states);
      pll_set_frequencies(part, idx, v);
      free(v);
    }
    else if (!strcmp(cmd, "subst"))
    {
      unsigned int idx; int off;
      unsigned int n = part->states * (part->states - 1) / 2;
      sscanf(rest, "%u%n", &idx, &off);
      double *v = read_doubles(rest + off, n);
      pll_set_subst_params(part, idx, v);
      free(v);
    }
    else if (!strcmp(cmd, "rates"))
    {
      double *v = read_doubles(rest, part->rate_cats);
      pll_set_category_rates(part, v);
      free(v);
    }
    else if (!strcmp(cmd, "rate_weights"))
    {
      double *v = read_doubles(rest, part->rate_cats);
      pll_set_category_weights(part, v);
      free(v);
    }
    else if (!strcmp(cmd, "gamma"))
    {
      double alpha; unsigned int n; char mode[16];
      sscanf(rest, "%lf %u %15s", &alpha, &n, mode);
      double *v = (double*)malloc(n * sizeof(double));
      if (!pll_compute_gamma_cats(alpha, n, v,
            strcmp(mode, "median") ? PLL_GAMMA_RATES_MEAN
                                   : PLL_GAMMA_RATES_MEDIAN))
        die("gamma");
      pll_set_category_rates(part, v);
      free(v);
    }
    else if (!strcmp(cmd, "pinv"))
    {
      unsigned int idx; double v;
      sscanf(rest, "%u %lf", &idx, &v);
      if (!pll_update_invariant_sites_proportion(part, idx, v))
        die("pinv");
    }
    else if (!strcmp(cmd, "tip"))
    {
      unsigned int idx; char *seq = (char*)malloc(LINE);
      sscanf(rest, "%u %s", &idx, seq);
      if (!pll_set_tip_states(part, idx, cur_map, seq)) die("tip");
      free(seq);
    }
    else if (!strcmp(cmd, "tipclv"))
    {
      unsigned int idx; int off;
      sscanf(rest, "%u%n", &idx, &off);
      unsigned int n = part->sites * part->rate_cats * part->states;
      double *v = read_doubles(rest + off, n);
      if (!pll_set_tip_clv(part, idx, v, PLL_FALSE)) die("tipclv");
      free(v);
    }
    else if (!strcmp(cmd, "pattern_weights"))
    {
      unsigned int i; int off = 0, used;
      unsigned int *w = (unsigned int*)malloc(part->sites * sizeof(unsigned int));
      char *p = rest;
      for (i = 0; i < part->sites; ++i)
      {
        if (sscanf(p, "%u%n", &w[i], &used) != 1) die("pattern_weights");
        p += used; (void)off;
      }
      pll_set_pattern_weights(part, w);
      free(w);
    }
    else if (!strcmp(cmd, "asc_bias"))
    {
      /* asc_bias lewis|felsenstein|stamatakis */
      char name[32];
      sscanf(rest, "%31s", name);
      int type = 0;
      if (!strcmp(name, "lewis")) type = PLL_ATTRIB_AB_LEWIS;
      else if (!strcmp(name, "felsenstein")) type = PLL_ATTRIB_AB_FELSENSTEIN;
      else if (!strcmp(name, "stamatakis")) type = PLL_ATTRIB_AB_STAMATAKIS;
      if (!pll_set_asc_bias_type(part, type)) die("asc_bias");
    }
    else if (!strcmp(cmd, "asc_weights"))
    {
      unsigned int i; int used;
      unsigned int *w = (unsigned int*)malloc(part->states * sizeof(unsigned int));
      char *p = rest;
      for (i = 0; i < part->states; ++i)
      {
        if (sscanf(p, "%u%n", &w[i], &used) != 1) die("asc_weights");
        p += used;
      }
      pll_set_asc_state_weights(part, w);
      free(w);
    }
    else if (!strcmp(cmd, "update_invariant_sites"))
    {
      if (!pll_update_invariant_sites(part)) die("update_invariant_sites");
    }
    else if (!strcmp(cmd, "pmatrices"))
    {
      unsigned int count, i; int off; char *p = rest; int used;
      sscanf(p, "%u%n", &count, &off); p += off;
      for (i = 0; i < part->rate_cats; ++i)
      {
        sscanf(p, "%u%n", &params_indices[i], &used); p += used;
      }
      unsigned int *mi = (unsigned int*)malloc(count * sizeof(unsigned int));
      double *bl = (double*)malloc(count * sizeof(double));
      for (i = 0; i < count; ++i)
      {
        if (!fgets(line, LINE, stdin)) die("pmatrices lines");
        sscanf(line, "%u %lf", &mi[i], &bl[i]);
      }
      if (!pll_update_prob_matrices(part, params_indices, mi, bl, count))
        die("update_prob_matrices");
      free(mi); free(bl);
    }
    else if (!strcmp(cmd, "op"))
    {
      int p, c1, c2, m1, m2, ps, s1, s2;
      sscanf(rest, "%d %d %d %d %d %d %d %d",
             &p, &c1, &c2, &m1, &m2, &ps, &s1, &s2);
      ops[nops].parent_clv_index = p;
      ops[nops].child1_clv_index = c1;
      ops[nops].child2_clv_index = c2;
      ops[nops].child1_matrix_index = m1;
      ops[nops].child2_matrix_index = m2;
      ops[nops].parent_scaler_index = ps;
      ops[nops].child1_scaler_index = s1;
      ops[nops].child2_scaler_index = s2;
      nops++;
    }
    else if (!strcmp(cmd, "partials"))
    {
      pll_update_partials(part, ops, nops);
      nops = 0;
    }
    else if (!strcmp(cmd, "root"))
    {
      int clv, scaler;
      sscanf(rest, "%d %d", &clv, &scaler);
      double *persite = (double*)malloc(part->sites * sizeof(double));
      double logl = pll_compute_root_loglikelihood(part, clv, scaler,
                                                   params_indices, persite);
      printf("root_logl %.17g\n", logl);
      printf("persite");
      for (unsigned int i = 0; i < part->sites; ++i)
        printf(" %.17g", persite[i]);
      printf("\n");
      free(persite);
    }
    else if (!strcmp(cmd, "edge"))
    {
      int pclv, pscaler, cclv, cscaler, pmat;
      sscanf(rest, "%d %d %d %d %d", &pclv, &pscaler, &cclv, &cscaler, &pmat);
      double *persite = (double*)malloc(part->sites * sizeof(double));
      double logl = pll_compute_edge_loglikelihood(part, pclv, pscaler,
                                                   cclv, cscaler, pmat,
                                                   params_indices, persite);
      printf("edge_logl %.17g\n", logl);
      printf("persite");
      for (unsigned int i = 0; i < part->sites; ++i)
        printf(" %.17g", persite[i]);
      printf("\n");
      free(persite);
    }
    else if (!strcmp(cmd, "sumtable"))
    {
      int pclv, pscaler, cclv, cscaler;
      sscanf(rest, "%d %d %d %d", &pclv, &pscaler, &cclv, &cscaler);
      unsigned int sites_alloc = part->asc_bias_alloc ?
          part->sites + part->states : part->sites;
      if (!sumtable)
        sumtable = (double*)pll_aligned_alloc(sites_alloc * part->rate_cats *
                                              part->states_padded *
                                              sizeof(double),
                                              part->alignment);
      sum_pscaler = pscaler; sum_cscaler = cscaler;
      if (!pll_update_sumtable(part, pclv, cclv, pscaler, cscaler,
                               params_indices, sumtable))
        die("sumtable");
      (void)sumtable_buf_storage;
    }
    else if (!strcmp(cmd, "derivatives"))
    {
      double blen, d1, d2;
      sscanf(rest, "%lf", &blen);
      if (!pll_compute_likelihood_derivatives(part,
                                              (int)sum_pscaler,
                                              (int)sum_cscaler,
                                              blen, params_indices,
                                              sumtable, &d1, &d2))
        die("derivatives");
      printf("derivatives %.17g %.17g %.17g\n", blen, d1, d2);
    }
    else if (!strcmp(cmd, "print_pmatrix"))
    {
      unsigned int idx, j, k, n;
      sscanf(rest, "%u", &idx);
      unsigned int states = part->states;
      unsigned int sp = part->states_padded;
      printf("pmatrix %u", idx);
      for (n = 0; n < part->rate_cats; ++n)
      {
        double *pm = part->pmatrix[idx] + n * states * sp;
        for (j = 0; j < states; ++j)
          for (k = 0; k < states; ++k)
            printf(" %.17g", pm[j * sp + k]);
      }
      printf("\n");
    }
    else if (!strcmp(cmd, "print_clv"))
    {
      unsigned int idx, n, k;
      sscanf(rest, "%u", &idx);
      unsigned int span = part->states_padded * part->rate_cats;
      unsigned int sites_alloc = part->asc_bias_alloc ?
          part->sites + part->states : part->sites;
      printf("clv %u", idx);
      for (n = 0; n < sites_alloc; ++n)
      {
        const double *clv = part->clv[idx] + n * span;
        for (k = 0; k < part->rate_cats; ++k)
        {
          unsigned int s;
          for (s = 0; s < part->states; ++s)
            printf(" %.17g", clv[k * part->states_padded + s]);
        }
      }
      printf("\n");
    }
    else if (!strcmp(cmd, "print_scaler"))
    {
      unsigned int idx, n;
      sscanf(rest, "%u", &idx);
      unsigned int size = (part->attributes & PLL_ATTRIB_RATE_SCALERS) ?
          part->sites * part->rate_cats : part->sites;
      if (part->asc_bias_alloc)
        size += part->states *
            ((part->attributes & PLL_ATTRIB_RATE_SCALERS) ? part->rate_cats : 1);
      printf("scaler %u", idx);
      for (n = 0; n < size; ++n)
        printf(" %u", part->scale_buffer[idx][n]);
      printf("\n");
    }
    else if (!strcmp(cmd, "show_pmatrix"))
    {
      unsigned int idx, prec;
      sscanf(rest, "%u %u", &idx, &prec);
      pll_show_pmatrix(part, idx, prec);
    }
    else if (!strcmp(cmd, "show_clv"))
    {
      int idx, scaler; unsigned int prec;
      sscanf(rest, "%d %d %u", &idx, &scaler, &prec);
      pll_show_clv(part, idx, scaler, prec);
    }
    else if (!strcmp(cmd, "print_rates"))
    {
      printf("rates");
      for (unsigned int i = 0; i < part->rate_cats; ++i)
        printf(" %.17g", part->rates[i]);
      printf("\n");
    }
    else if (!strcmp(cmd, "print_eigen"))
    {
      unsigned int idx, i, j;
      sscanf(rest, "%u", &idx);
      if (!part->eigen_decomp_valid[idx])
        if (!pll_update_eigen(part, idx)) die("update_eigen");
      unsigned int st = part->states, sp = part->states_padded;
      printf("eigenvals %u", idx);
      for (i = 0; i < st; ++i) printf(" %.17g", part->eigenvals[idx][i]);
      printf("\neigenvecs %u", idx);
      for (i = 0; i < st; ++i)
        for (j = 0; j < st; ++j)
          printf(" %.17g", part->eigenvecs[idx][i * sp + j]);
      printf("\ninv_eigenvecs %u", idx);
      for (i = 0; i < st; ++i)
        for (j = 0; j < st; ++j)
          printf(" %.17g", part->inv_eigenvecs[idx][i * sp + j]);
      printf("\n");
    }
    else if (!strcmp(cmd, "ancestral"))
    {
      int nclv, nscaler, oclv, oscaler, pmat;
      unsigned int n;
      sscanf(rest, "%d %d %d %d %d", &nclv, &nscaler, &oclv, &oscaler, &pmat);
      double *anc = (double*)malloc(part->sites * part->states *
                                    sizeof(double));
      if (!pll_compute_node_ancestral(part, nclv, nscaler, oclv, oscaler,
                                      pmat, params_indices, anc))
        die("compute_node_ancestral");
      printf("ancestral");
      for (n = 0; n < part->sites * part->states; ++n)
        printf(" %.17g", anc[n]);
      printf("\n");
      free(anc);
    }
    else if (!strcmp(cmd, "pars_create"))
    {
      unsigned int tips, states, sites, sb, ab;
      if (sscanf(rest, "%u %u %u %u %u", &tips, &states, &sites, &sb, &ab)
          != 5) die("pars_create args");
      if (!fgets(line, LINE, stdin)) die("pars_create matrix line");
      double *m = read_doubles(line, states * states);
      spars = pll_parsimony_create(tips, states, sites, m, sb, ab);
      if (!spars) die("parsimony_create");
      free(m);
    }
    else if (!strcmp(cmd, "pars_tip"))
    {
      unsigned int idx; char *seq = (char*)malloc(LINE);
      sscanf(rest, "%u %s", &idx, seq);
      if (!pll_set_parsimony_sequence(spars, idx, cur_map, seq))
        die("pars_tip");
      free(seq);
    }
    else if (!strcmp(cmd, "pars_op"))
    {
      unsigned int p, c1, c2;
      sscanf(rest, "%u %u %u", &p, &c1, &c2);
      parsops[nparsops].parent_score_index = p;
      parsops[nparsops].child1_score_index = c1;
      parsops[nparsops].child2_score_index = c2;
      nparsops++;
    }
    else if (!strcmp(cmd, "pars_build"))
    {
      double score = pll_parsimony_build(spars, parsops, nparsops);
      printf("pars_build_score %.17g\n", score);
      nparsops = 0;
    }
    else if (!strcmp(cmd, "pars_score"))
    {
      unsigned int idx;
      sscanf(rest, "%u", &idx);
      printf("pars_score %.17g\n", pll_parsimony_score(spars, idx));
    }
    else if (!strcmp(cmd, "pars_recop"))
    {
      unsigned int ns, na, ps, pa;
      sscanf(rest, "%u %u %u %u", &ns, &na, &ps, &pa);
      recops[nrecops].node_score_index = ns;
      recops[nrecops].node_ancestral_index = na;
      recops[nrecops].parent_score_index = ps;
      recops[nrecops].parent_ancestral_index = pa;
      nrecops++;
    }
    else if (!strcmp(cmd, "pars_reconstruct"))
    {
      unsigned int i, n;
      pll_parsimony_reconstruct(spars, cur_map, recops, nrecops);
      for (i = 0; i < nrecops; ++i)
      {
        unsigned int *anc = spars->anc_states[recops[i].node_ancestral_index];
        printf("pars_anc %u ", recops[i].node_ancestral_index);
        for (n = 0; n < spars->sites; ++n)
          putchar((char)anc[n]);
        putchar('\n');
      }
      nrecops = 0;
    }
    else if (!strcmp(cmd, "fastpars_init"))
    {
      fpars = pll_fastparsimony_init(part);
      if (!fpars) die("fastparsimony_init");
      printf("fastpars_const %u\n", fpars->const_cost);
      printf("fastpars_informative %u\n", fpars->informative_count);
    }
    else if (!strcmp(cmd, "fastpars_op"))
    {
      unsigned int p, c1, c2;
      sscanf(rest, "%u %u %u", &p, &c1, &c2);
      parsops[nparsops].parent_score_index = p;
      parsops[nparsops].child1_score_index = c1;
      parsops[nparsops].child2_score_index = c2;
      nparsops++;
    }
    else if (!strcmp(cmd, "fastpars_update"))
    {
      pll_fastparsimony_update_vectors(fpars, parsops, nparsops);
      nparsops = 0;
    }
    else if (!strcmp(cmd, "fastpars_edge"))
    {
      unsigned int i, j;
      sscanf(rest, "%u %u", &i, &j);
      printf("fastpars_edge %u\n", pll_fastparsimony_edge_score(fpars, i, j));
    }
    else if (!strcmp(cmd, "fastpars_root"))
    {
      unsigned int i;
      sscanf(rest, "%u", &i);
      printf("fastpars_root %u\n", pll_fastparsimony_root_score(fpars, i));
    }
    else if (!strcmp(cmd, "stepwise"))
    {
      /* stepwise <seed>: randomized stepwise-addition tree from the Fitch
         parsimony struct (labels auto-generated t0..tN-1) */
      unsigned int seed, i;
      sscanf(rest, "%u", &seed);
      unsigned int tips = part->tips;
      char **labels = (char**)malloc(tips * sizeof(char*));
      for (i = 0; i < tips; ++i)
      {
        labels[i] = (char*)malloc(16);
        snprintf(labels[i], 16, "t%u", i);
      }
      unsigned int cost;
      pll_parsimony_t *plist[1] = { fpars };
      stepwise_tree = pll_fastparsimony_stepwise(plist, labels, &cost, 1,
                                                 seed);
      if (!stepwise_tree) die("stepwise");
      char *nwk = pll_utree_export_newick(stepwise_tree->vroot, NULL);
      printf("stepwise_cost %u\n", cost);
      printf("stepwise_tree %s\n", nwk);
      free(nwk);
      for (i = 0; i < tips; ++i) free(labels[i]);
      free(labels);
    }
    else if (!strcmp(cmd, "svg_lengths"))
    {
      /* deterministic branch lengths keyed on node indices so the Python
         side can reproduce them exactly */
      unsigned int i;
      unsigned int n = stepwise_tree->tip_count + stepwise_tree->inner_count;
      for (i = 0; i < n; ++i)
      {
        pll_unode_t *node = stepwise_tree->nodes[i];
        pll_unode_t *h = node;
        do {
          unsigned int a = h->node_index, b = h->back->node_index;
          unsigned int lo = a < b ? a : b;
          double len = 0.05 * ((lo % 10) + 1);
          h->length = h->back->length = len;
          h = h->next;
        } while (h && h != node);
      }
    }
    else if (!strcmp(cmd, "ascii_utree"))
    {
      /* ascii_utree <options> <newick>: build the node graph (minimal
         parser below — the reference's bison grammar needs flex/bison,
         unavailable here) and render via the REFERENCE
         pll_utree_show_ascii, between marker lines (raw stdout).
         Ring convention mirrors parse_utree.y: entry half-node backs the
         first child, siblings follow in input order. */
      int options; int off = 0;
      sscanf(rest, "%d%n", &options, &off);
      const char *nwk = rest + off;
      while (*nwk == ' ' || *nwk == '\t') nwk++;
      pll_unode_t *root = ascii_parse_newick(nwk);
      if (!root) die("ascii_utree parse");
      printf("ascii_begin\n");
      fflush(stdout);
      pll_utree_show_ascii(root, options);
      fflush(stdout);
      printf("ascii_end\n");
      pll_utree_graph_destroy(root, NULL);
    }
    else if (!strcmp(cmd, "ascii_rtree"))
    {
      /* ascii_rtree <options> <rooted newick> (binary) */
      int options; int off = 0;
      sscanf(rest, "%d%n", &options, &off);
      const char *nwk = rest + off;
      while (*nwk == ' ' || *nwk == '\t') nwk++;
      pll_rnode_t *root = ascii_rsubtree(&nwk);
      if (!root) die("ascii_rtree parse");
      printf("ascii_begin\n");
      fflush(stdout);
      pll_rtree_show_ascii(root, options);
      fflush(stdout);
      printf("ascii_end\n");
      ascii_rdestroy(root);
    }
    else if (!strcmp(cmd, "svg"))
    {
      /* svg <path>: export the stepwise tree as SVG (default attribs) */
      char path[512];
      sscanf(rest, "%511s", path);
      pll_svg_attrib_t *attr = pll_svg_attrib_create();
      if (!pll_utree_export_svg(stepwise_tree, stepwise_tree->vroot, attr,
                                path))
        die("svg export");
      pll_svg_attrib_destroy(attr);
      printf("svg_written %s\n", path);
    }
    else if (!strcmp(cmd, "stepwise_spr"))
    {
      /* stepwise_spr <seed>: one unconstrained SPR round on the stepwise
         tree (all-zero clv_index_map disables the constraint) */
      unsigned int seed;
      sscanf(rest, "%u", &seed);
      unsigned int nodes = stepwise_tree->tip_count +
                           stepwise_tree->inner_count;
      int *map = (int*)calloc(nodes, sizeof(int));
      unsigned int cost;
      pll_parsimony_t *plist[1] = { fpars };
      if (!pll_fastparsimony_stepwise_spr_round(stepwise_tree, plist, 1,
                                                NULL, seed, map, &cost))
        die("stepwise_spr");
      char *nwk = pll_utree_export_newick(stepwise_tree->vroot, NULL);
      printf("spr_cost %u\n", cost);
      printf("spr_tree %s\n", nwk);
      free(nwk);
      free(map);
    }
    else
    {
      fprintf(stderr, "unknown command: %s\n", cmd);
      exit(1);
    }
  }
  if (part) pll_partition_destroy(part);
  free(line);
  return 0;
}
